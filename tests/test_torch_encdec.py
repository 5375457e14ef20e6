"""whisper-base (encoder-decoder) and bert-110m (encoder) in the port, on the
CPU against the JAX reference: the configs field for field; the parameter
trees; whisper's smoke config (2 + 2 layers, d 64) forward, prefill and 4
teacher-forced decode steps in both of the port's modes against the JAX
model in 'reference' mode and in 'pallas_interpret' with
``autotune.select_fusion`` pinned to the fused plans (the layernorm
prologue in the q|k, v and up GEMMs, gelu in the up GEMM's store); the
greedy streams of ``Engine.generate(..., extra_batch=...)``; bert at the
reference test's 2-layer width; the decode step at a device position (what
a captured step reads) bit for bit the int one, and an engine's reused
{"self", "cross"} cache; the loss of both; and what stays refused (the
serving CLI, the paged surface, an encoder's cache).

Both sides run the same weights: the reference's seeded init converted
with ``params_from_numpy``, and the same numpy encoder embeddings. fp32
compute, so the comparison is of the algorithm: logits within 1e-4 of
their largest magnitude (sums in another order, as
``tests/test_torch_configs.py``).
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import obs
from repro.configs import get_config as j_get_config
from repro.core import autotune
from repro.models import build_model as j_build_model
from repro.models.encdec import encdec_param_defs as j_encdec_param_defs
from repro.models.encoder import encoder_param_defs as j_encoder_param_defs
from repro.serve import Engine as JEngine

from repro_torch.configs import ModelConfig, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.encdec import sinusoidal_positions
from repro_torch.serve import Engine, PagedEngine
from repro_torch.serve.engine import DecodeGraph

B, S, STEPS, MAX_LEN = 2, 10, 4, 24
# the reference's GEMM chains (prologue|epilogue) on the fused plans: q|k
# and v, the gelu up projection, the down projection's residual store
FUSED_CHAINS = ["layernorm+beta|gelu", "layernorm+beta|none",
                "none|scale+res"]
MODES = ("kernel", "reference")
# bert at tests/test_models.py::test_bert_mlm_smoke's width
BERT_SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                  d_ff=128, vocab_size=256, max_seq_len=64)


def _tol(want):
    return 1e-4 * float(np.abs(want).max())


def _cfgs(arch):
    """(JAX, port) configs in fp32: whisper's smoke config, bert at the
    reference test's width."""
    if arch == "bert-110m":
        return tuple(dataclasses.replace(get(arch), compute_dtype="float32",
                                         **BERT_SMALL)
                     for get in (j_get_config, get_config))
    return tuple(dataclasses.replace(get(arch, smoke=True),
                                     compute_dtype="float32")
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params(arch):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """(encoder embeddings (B, S_enc, D), tokens (B, S + STEPS)), seeded."""
    _, cfg = _cfgs(arch)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    return emb, toks


@contextlib.contextmanager
def jax_fused():
    """Pin the reference's fusion decisions to the fused plans (its byte
    model decides per shape): the rope-free QKV chain ('qkv': the norm in
    the q|k and v GEMMs' prologue) and the MLP chain ('mlp'). Plans are
    memoised, so the caches are cleared on the way in and out."""
    orig = autotune.select_fusion

    def pinned(kind, shape, dtype="bfloat16", **kw):
        out = orig(kind, shape, dtype, **kw)
        return dict(out, plan="fused") if kind in ("qkv", "mlp") else out

    autotune.clear_policy_cache()
    autotune.select_fusion = pinned
    try:
        yield
    finally:
        autotune.select_fusion = orig
        autotune.clear_policy_cache()


@functools.lru_cache(maxsize=None)
def _jax_whisper(mode):
    """{forward, prefill, steps} logits of the JAX model, and the gemm_fused
    chains its launch journal recorded."""
    jcfg, _ = _cfgs("whisper-base")
    emb, toks = _inputs("whisper-base")
    params = jax.tree.map(jnp.asarray, _np_params("whisper-base"))
    ctx = jax_fused() if mode != "reference" else contextlib.nullcontext()
    with ctx, obs.capture() as cap:
        m = j_build_model(jcfg, mode=mode)
        batch = {"encoder_embeds": jnp.asarray(emb),
                 "inputs": jnp.asarray(toks)}
        out = {"forward": np.asarray(m.forward(params, batch)[0])}
        cache, lg = m.prefill(params, dict(batch, inputs=batch["inputs"][:,
                                                                         :S]),
                              m.init_cache(B, MAX_LEN))
        out["prefill"] = np.asarray(lg)
        out["steps"] = []
        for i in range(STEPS):
            cache, lg = m.decode_step(params, batch["inputs"][:, S + i:
                                                              S + i + 1],
                                      cache, S + i)
            out["steps"].append(np.asarray(lg))
    out["chains"] = sorted({e.chain for e in cap.launches
                            if e.op == "gemm_fused"})
    return out


def _port_whisper(mode):
    _, tcfg = _cfgs("whisper-base")
    emb, toks = _inputs("whisper-base")
    m = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params("whisper-base"), "cpu",
                               torch.float32)
    batch = {"encoder_embeds": torch.from_numpy(emb),
             "inputs": torch.from_numpy(toks).long()}
    with torch.no_grad():
        out = {"forward": m.forward(params, batch).numpy()}
        cache, lg = m.prefill(params, dict(batch,
                                           inputs=batch["inputs"][:, :S]),
                              m.init_cache(B, MAX_LEN))
        out["prefill"] = lg.numpy()
        out["steps"] = []
        for i in range(STEPS):
            cache, lg = m.decode_step(params,
                                      batch["inputs"][:, S + i:S + i + 1],
                                      cache, S + i)
            out["steps"].append(lg.numpy())
    return out


# ---------------------------------------------------------------------------
# the registry and the parameter trees
# ---------------------------------------------------------------------------

def _same_fields(got, want):
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
def test_whisper_config_is_the_references(smoke):
    got = get_config("whisper-base", smoke=smoke)
    _same_fields(got, j_get_config("whisper-base", smoke=smoke))
    assert got.family == "encdec" and got.name.endswith("-smoke") == smoke


def test_bert_id_returns_its_one_config():
    assert get_config("bert-110m", smoke=True) is get_config("bert-110m")
    _same_fields(get_config("bert-110m"), j_get_config("bert-110m"))
    assert get_config("bert-110m").family == "encoder"


@pytest.mark.parametrize("arch,jdefs", [
    ("whisper-base", j_encdec_param_defs), ("bert-110m", j_encoder_param_defs)])
@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
def test_param_defs_match_reference(arch, jdefs, smoke):
    """The keys, shapes and inits of the reference's trees: enc/*,
    dec/{attn, xattn, mlp}, the norms' biases, dec_pos or pos and
    enc_final_norm; the cross blocks carry no q|k/v bias even with
    qkv_bias."""
    for extra in ({}, dict(qkv_bias=True)):
        jcfg = dataclasses.replace(j_get_config(arch, smoke=smoke), **extra)
        tcfg = dataclasses.replace(get_config(arch, smoke=smoke), **extra)
        want = jdefs(jcfg)
        got = build_model(tcfg, device="cpu").defs
        assert sorted(got) == sorted(want)
        for key, d in want.items():
            assert tuple(got[key].shape) == tuple(d.shape), key
            assert (got[key].init, got[key].scale) == (d.init, d.scale), key
    if arch == "whisper-base":
        assert "dec/xattn/bqk" not in got and "dec/attn/bqk" in got


@pytest.mark.parametrize("arch", ["whisper-base", "bert-110m"])
def test_params_from_numpy_carries_the_trees(arch):
    """Every leaf of the reference's init reaches the port's model with
    its key, shape and values (fp32), and the port's own init makes the
    same tree."""
    np_params = _np_params(arch)
    got = params_from_numpy(np_params, "cpu", torch.float32)
    flat_want = dict(_flat(np_params))
    flat_got = dict(_flat(got))
    assert sorted(flat_got) == sorted(flat_want)
    for key, arr in flat_want.items():
        assert np.array_equal(flat_got[key].numpy(), arr), key
    own = build_model(_cfgs(arch)[1], device="cpu").init(seed=0)
    assert sorted(dict(_flat(own))) == sorted(flat_want)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_sinusoidal_positions_are_the_references():
    from repro.models.encdec import sinusoidal_positions as j_sin
    want = np.asarray(j_sin(1500, 512))
    got = sinusoidal_positions(1500, 512).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


# ---------------------------------------------------------------------------
# whisper: logits in both modes against both of the reference's modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jmode", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("mode", MODES)
def test_whisper_logits_match_jax(mode, jmode):
    """Forward, prefill and 4 teacher-forced decode steps within 1e-4 of
    the logits' largest magnitude. The interpret-mode reference takes the
    fused plans: its journal shows the layernorm+beta prologue in its GEMMs
    (q|k, v, up) and gelu in the up GEMM's store, as the port's kernel mode
    runs them."""
    want = _jax_whisper(jmode)
    got = _port_whisper(mode)
    atol = _tol(want["forward"])
    for key in ("forward", "prefill"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=f"step {i}")
    if jmode == "pallas_interpret":
        assert want["chains"] == FUSED_CHAINS


def test_whisper_prefill_fills_both_caches_in_place():
    """The prefill writes the self ring's first S slots and every layer's
    cross k/v (the projections of the encoder output, S_enc slots) into the
    tensors it was given; the decode steps append to the ring only."""
    _, tcfg = _cfgs("whisper-base")
    emb, toks = _inputs("whisper-base")
    m = build_model(tcfg, mode="kernel", device="cpu")
    params = params_from_numpy(_np_params("whisper-base"), "cpu",
                               torch.float32)
    cache = m.init_cache(B, MAX_LEN)
    ids = {k: v.data_ptr() for k, v in cache["cross"].items()}
    assert cache["cross"]["k"].shape == (tcfg.num_layers, B,
                                         tcfg.num_kv_heads, tcfg.encoder_seq,
                                         tcfg.head_dim)
    with torch.no_grad():
        out, _ = m.prefill(params, {"encoder_embeds": torch.from_numpy(emb),
                                    "inputs": torch.from_numpy(
                                        toks[:, :S]).long()}, cache)
        cross = {k: v.clone() for k, v in cache["cross"].items()}
        m.decode_step(params, torch.from_numpy(toks[:, S:S + 1]).long(),
                      cache, S)
    assert out is cache
    assert {k: v.data_ptr() for k, v in cache["cross"].items()} == ids
    for key in ("k", "v"):
        assert torch.equal(cache["cross"][key], cross[key])
        assert bool((cross[key] != 0).any(dim=-1).all())
        ring = cache["self"][key]
        assert bool((ring[:, :, :, :S + 1] != 0).any(dim=-1).all())
        assert not bool((ring[:, :, :, S + 1:] != 0).any())


# ---------------------------------------------------------------------------
# whisper: Engine.generate's greedy streams
# ---------------------------------------------------------------------------

def _gen_prompts():
    rng = np.random.default_rng(4)
    _, cfg = _cfgs("whisper-base")
    return (rng.integers(0, cfg.vocab_size, (B, 7)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_streams(jmode):
    jcfg, _ = _cfgs("whisper-base")
    emb, _ = _inputs("whisper-base")
    ctx = jax_fused() if jmode != "reference" else contextlib.nullcontext()
    with ctx:
        eng = JEngine(j_build_model(jcfg, mode=jmode),
                      jax.tree.map(jnp.asarray, _np_params("whisper-base")),
                      max_len=MAX_LEN)
        return [np.asarray(eng.generate(p, 6, extra_batch={
            "encoder_embeds": jnp.asarray(emb)}).tokens)
            for p in _gen_prompts()]


@pytest.mark.parametrize("jmode", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("mode", MODES)
def test_whisper_engine_streams_equal_jax(mode, jmode):
    """Two generate calls (prompts of 7 and 12 tokens, 6 new tokens,
    greedy) with the encoder's input in extra_batch: the JAX engine's
    streams token for token, in both of its modes (the interpret-mode
    kernels on the fused plans); the second call decodes into the first's
    {"self", "cross"} cache, which its prefill rewrote in place."""
    _, tcfg = _cfgs("whisper-base")
    emb, _ = _inputs("whisper-base")
    model = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params("whisper-base"), "cpu",
                               torch.float32)
    eng = Engine(model, params, max_len=MAX_LEN)
    got = []
    for p in _gen_prompts():
        got.append(eng.generate(p, 6, extra_batch={
            "encoder_embeds": emb}).tokens)
    assert set(eng._buckets[("decode", B)].cache) == {"self", "cross"}
    assert eng.lru_stats == {"hits": 1, "misses": 3, "evictions": 0}
    for g, w in zip(got, _jax_streams(jmode)):
        np.testing.assert_array_equal(g, w)


def test_whisper_engine_needs_the_encoder_input():
    _, tcfg = _cfgs("whisper-base")
    model = build_model(tcfg, mode="kernel", device="cpu")
    params = params_from_numpy(_np_params("whisper-base"), "cpu",
                               torch.float32)
    with pytest.raises(ValueError, match="encoder_embeds"):
        Engine(model, params, max_len=MAX_LEN).generate(_gen_prompts()[0], 2)


# ---------------------------------------------------------------------------
# the decode step a CUDA graph captures, on an encdec cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_device_position_decode_step_is_bitwise_the_int_path(mode):
    """encdec_decode_step with the position as a one-element int64 tensor
    (dec_pos gathered by index_select, the slot and lengths derived on the
    device) gives the int path's logits and both caches bit for bit; the
    cross cache is never written."""
    _, tcfg = _cfgs("whisper-base")
    emb, toks = _inputs("whisper-base")
    model = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params("whisper-base"), "cpu",
                               torch.float32)
    batch = {"encoder_embeds": torch.from_numpy(emb),
             "inputs": torch.from_numpy(toks[:, :5]).long()}
    caches = []
    with torch.no_grad():
        for _ in range(2):
            cache, _ = model.prefill(params, batch,
                                     model.init_cache(B, MAX_LEN))
            caches.append(cache)
        cross = {k: v.clone() for k, v in caches[0]["cross"].items()}
        for i in range(5, 12):
            tok = torch.from_numpy(toks[:, i:i + 1]).long()
            _, want = model.decode_step(params, tok, caches[0], i)
            _, got = model.decode_step(params, tok, caches[1],
                                       torch.tensor([i], dtype=torch.int64))
            assert torch.equal(got, want)
            for part in ("self", "cross"):
                for key in ("k", "v"):
                    assert torch.equal(caches[1][part][key],
                                       caches[0][part][key])
    for key in ("k", "v"):
        assert torch.equal(caches[0]["cross"][key], cross[key])


def test_decode_bucket_owns_the_encdec_cache():
    """The ("decode", batch) bucket is a DecodeGraph over the token and
    position buffers whose cache is the model's whole {"self", "cross"}
    pair; on the CPU it runs the eager step over those buffers, as it
    does for an lm."""
    _, tcfg = _cfgs("whisper-base")
    model = build_model(tcfg, mode="kernel", device="cpu")
    params = params_from_numpy(_np_params("whisper-base"), "cpu",
                               torch.float32)
    eng = Engine(model, params, max_len=MAX_LEN)
    with torch.inference_mode():
        entry = eng._decode_fn(B)
        assert isinstance(entry, DecodeGraph)
        assert set(entry.buffers) == {"token", "pos"}
        assert set(entry.cache) == {"self", "cross"}
        logits = entry(token=np.array([[3], [4]]), pos=2)
    assert logits.shape == (B, tcfg.vocab_size) and entry.graph is None


# ---------------------------------------------------------------------------
# bert
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_bert(mode):
    jcfg, _ = _cfgs("bert-110m")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, 32))
    params = jax.tree.map(jnp.asarray, _np_params("bert-110m"))
    ctx = jax_fused() if mode != "reference" else contextlib.nullcontext()
    with ctx, obs.capture() as cap:
        out = np.asarray(j_build_model(jcfg, mode=mode).forward(
            params, {"inputs": jnp.asarray(toks, jnp.int32)})[0])
    return toks, out, sorted({e.chain for e in cap.launches
                              if e.op == "gemm_fused"})


@pytest.mark.parametrize("jmode", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("mode", MODES)
def test_bert_logits_match_jax(mode, jmode):
    """bert at 2 layers, d 64: the MLM logits of a (2, 32) batch within
    1e-4 of their largest magnitude; the batch dict and the bare tokens
    give the same logits."""
    toks, want, chains = _jax_bert(jmode)
    _, tcfg = _cfgs("bert-110m")
    model = build_model(tcfg, mode=mode, device="cpu")
    params = params_from_numpy(_np_params("bert-110m"), "cpu", torch.float32)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        got = model.forward(params, {"inputs": t}).numpy()
        bare = model.forward(params, t).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))
    assert np.array_equal(got, bare)
    if jmode == "pallas_interpret":
        assert chains == FUSED_CHAINS


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

def test_encoder_has_no_cache():
    """As the reference's test_bert_mlm_smoke expects of its model."""
    _, tcfg = _cfgs("bert-110m")
    model = build_model(tcfg, mode="kernel", device="cpu")
    for call in (lambda: model.init_cache(2, 64),
                 lambda: model.prefill({}, None, None),
                 lambda: model.decode_step({}, None, None, 0)):
        with pytest.raises(NotImplementedError, match="no decode step"):
            call()


@pytest.mark.parametrize("arch", ["whisper-base", "bert-110m"])
def test_loss_and_paged_surface_raise(arch):
    """The loss is ported (tests/test_torch_encoder_train.py holds its
    grads): the kernel mode's loss equals the JAX model's in fp32 within
    1e-5 relative; the paged surface stays refused."""
    jcfg, tcfg = _cfgs(arch)
    model = build_model(tcfg, mode="kernel", device="cpu")
    emb, toks = _inputs(arch)
    batch = {"inputs": toks[:, :S], "targets": toks[:, 1:S + 1]}
    if arch == "whisper-base":
        batch["encoder_embeds"] = emb
    want, _ = j_build_model(jcfg, mode="reference").loss(
        jax.tree.map(jnp.asarray, _np_params(arch)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(_np_params(arch), "cpu", torch.float32)
    with torch.no_grad():
        got, metrics = model.loss(params, {
            k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32
                                      else torch.float32)
            for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    with pytest.raises(NotImplementedError, match="no paged path"):
        model.init_paged_cache(2, 8, 4)
    with pytest.raises(NotImplementedError, match="no paged path"):
        model.decode_step_paged({}, None, None, None, None)
    if arch == "whisper-base":
        with pytest.raises(NotImplementedError, match="no paged path"):
            PagedEngine(model, {}, batch_slots=2, page_size=4,
                        max_pages_per_seq=4)


@pytest.mark.parametrize("arch", ["whisper-base", "bert-110m"])
def test_serving_cli_refuses_other_families(arch):
    """The CLI's request queue serves decoder-only LMs, as the reference's;
    it refuses these before building a model."""
    with pytest.raises(NotImplementedError, match="decoder-only"):
        launch_serve.main(["--arch", arch, "--device", "cpu",
                           "--requests", "1"])
