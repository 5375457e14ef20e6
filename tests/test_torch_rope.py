"""The port's RoPE op and the QKV ladder's rungs 2 and 3 on the CPU against
the JAX reference.

The op: the same numpy inputs through the port's ``rope`` (its plain
version on CPU tensors), the reference's ``rope_ref`` and its Pallas kernel
in interpret mode; its backward against ``jax.grad`` through the
reference's custom VJP (the same kernel with -sin).

The ladder: the reference picks the rung from its byte model (rung 1 at
every llama shape), so its tests pin ``autotune.select_fusion`` to the rung
under test, and each test checks from the reference's launch journal that
it really took that rung. The port is given the rung as ``qkv_plan``.
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
from repro.kernels.rope import rope as j_rope
from repro.kernels.rope import rope_pallas, rope_ref as j_rope_ref
from repro.kernels.rope import rope_tables as j_rope_tables
from repro.models import attention as j_attention
from repro.models import build_model as j_build_model
from repro.models.lm import lm_param_defs as j_lm_param_defs
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue

from repro_torch.configs import get_config
from repro_torch.data import batch_at, DataConfig
from repro_torch.kernels.rope import rope, rope_ref, rope_tables
from repro_torch.models import attention as t_attention
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import nest, tree_map
from repro_torch.optim.optimizer import named_leaves
from repro_torch.serve import Engine, Request, RequestQueue
from repro_torch.train import loss_and_grads


def _bf16_ulp(x):
    """One bf16 ulp of each entry of x (8 significant bits)."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, e - 8)


def _within_one_bf16_ulp(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = np.maximum(_bf16_ulp(want), _bf16_ulp(got))
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------

ROPE_SHAPES = [(2, 4, 128, 64), (1, 2, 256, 128)]


def _rope_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = np.arange(shape[2])
    return x, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ROPE_SHAPES, ids=str)
def test_rope_matches_jax(shape, dtype):
    """The port's tables equal the reference's within 1e-6 (both fp32); the
    rotation within 1e-6 in fp32 and one bf16 ulp in bf16, against the
    reference's plain version and its interpret-mode kernel."""
    x, pos = _rope_inputs(shape)
    jdt = getattr(jnp, dtype)
    jsin, jcos = j_rope_tables(jnp.asarray(pos), shape[3])
    sin, cos = rope_tables(torch.from_numpy(pos), shape[3])
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    jx = jnp.asarray(x).astype(jdt)
    want_ref = np.asarray(j_rope_ref(jx, jsin, jcos).astype(jnp.float32))
    want_kernel = np.asarray(rope_pallas(jx, jsin, jcos, interpret=True)
                             .astype(jnp.float32))
    got = rope(torch.from_numpy(x).to(getattr(torch, dtype)), sin, cos)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    got = got.float().numpy()
    for want in (want_ref, want_kernel):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            _within_one_bf16_ulp(got, want)


def test_rope_reads_strided_views():
    """q and k as the model hands them over: transposed views of the packed
    (B, S, (H + Hkv) x D) projection output. The op gives what it gives on
    contiguous copies."""
    b, s, h, hkv, d = 2, 128, 4, 2, 64
    rng = np.random.default_rng(1)
    qk = torch.from_numpy(rng.standard_normal(
        (b, s, (h + hkv) * d)).astype(np.float32)).to(torch.bfloat16)
    q = qk[..., : h * d].reshape(b, s, h, d).transpose(1, 2)
    k = qk[..., h * d:].reshape(b, s, hkv, d).transpose(1, 2)
    sin, cos = rope_tables(torch.arange(s), d)
    for view in (q, k):
        assert not view.is_contiguous()
        assert torch.equal(rope(view, sin, cos),
                           rope_ref(view.contiguous(), sin, cos))


@pytest.mark.parametrize("shape", ROPE_SHAPES, ids=str)
def test_rope_backward_matches_jax_grad(shape):
    """The autograd backward (the rotation by -theta) against jax.grad
    through the reference's custom VJP (its kernel with -sin, interpret
    mode), fp32, within 1e-6; no gradient reaches the tables."""
    x, pos = _rope_inputs(shape, seed=2)
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jsin, jcos = j_rope_tables(jnp.asarray(pos), shape[3])
    want = jax.grad(lambda a: jnp.sum(
        j_rope(a, jsin, jcos, mode="pallas_interpret") * jnp.asarray(w)))(
        jnp.asarray(x))
    sin, cos = rope_tables(torch.from_numpy(pos), shape[3])
    sin.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    (rope(xt, sin, cos) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert sin.grad is None


def test_rope_rejects_mismatched_tables():
    x = torch.zeros(1, 2, 8, 64)
    sin, cos = rope_tables(torch.arange(4), 64)
    with pytest.raises(ValueError, match="do not match"):
        rope(x, sin, cos)


# ---------------------------------------------------------------------------
# The ladder
# ---------------------------------------------------------------------------

SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)
B, S = 2, 128
PLANS = ["norm_fused", "unfused"]
# select_fusion decisions that put the reference on each rung
_RUNGS = {"norm_fused": {"qkv_rope": "unfused", "qkv": "fused"},
          "unfused": {"qkv_rope": "unfused", "qkv": "unfused"}}


@contextlib.contextmanager
def jax_rung(plan):
    """Pin the reference's QKV ladder to the rung ``plan`` names: its byte
    model's decisions for the 'qkv_rope' and 'qkv' chains are overridden,
    every other chain keeps its own. Plans are memoised, so the caches are
    cleared on the way in and out."""
    orig = autotune.select_fusion
    overrides = _RUNGS[plan]

    def pinned(kind, shape, dtype="bfloat16", **kw):
        out = orig(kind, shape, dtype, **kw)
        return dict(out, plan=overrides[kind]) if kind in overrides else out

    autotune.clear_policy_cache()
    autotune.select_fusion = pinned
    try:
        yield
    finally:
        autotune.select_fusion = orig
        autotune.clear_policy_cache()


def _check_rung(cap, plan, rope_launches):
    """The journal shows the rung: the standalone rotation ran (as the
    kernel, ``rope_launches`` times), and the standalone norm ran only on
    rung 3."""
    assert cap.count("rope") == rope_launches, cap.launch_counts()
    assert cap.counters.get("model.standalone_rope", 0) > 0
    assert (cap.counters.get("model.standalone_norm", 0) > 0) \
        == (plan == "unfused"), cap.counters


def _cfgs(dtype="float32", **extra):
    return (dataclasses.replace(j_get_config("llama-1b"), compute_dtype=dtype,
                                **SMALL, **extra),
            dataclasses.replace(get_config("llama-1b"), compute_dtype=dtype,
                                **SMALL, **extra))


@functools.lru_cache(maxsize=None)
def _np_params(seed=0):
    """Weights at a trained-model scale (std fan_in^-1/2 over each matrix's
    input dim, the tied embedding's over d_model), so the grads are not
    rounding noise."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, d in sorted(j_lm_param_defs(_cfgs()[0]).items()):
        if d.init == "ones":
            flat[path] = np.ones(d.shape, np.float32)
        elif d.init == "zeros":
            flat[path] = np.zeros(d.shape, np.float32)
        else:
            fan_in = d.shape[-1] if path == "embed" else d.shape[-2]
            flat[path] = (rng.standard_normal(d.shape)
                          / np.sqrt(fan_in)).astype(np.float32)
    return nest(flat)


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (B, S)).astype(np.int32)


def _port_model(plan, **extra):
    return build_model(_cfgs(**extra)[1], mode="kernel", device="cpu",
                       qkv_plan=plan)


@pytest.mark.parametrize("plan", PLANS)
def test_lm_forward_rung_matches_jax_f32(plan):
    """Every position's logits at S = 128, fp32, within 1e-4 of their scale;
    the reference journals the rotation kernel for q and k of the one layer
    its scan traces."""
    toks = _tokens()
    jparams = jax.tree.map(jnp.asarray, _np_params())
    with jax_rung(plan), obs.capture() as cap:
        want, _ = j_build_model(_cfgs()[0], mode="pallas_interpret").forward(
            jparams, jnp.asarray(toks))
    _check_rung(cap, plan, 2)
    want = np.asarray(want, np.float32)
    got = _port_model(plan).forward(
        params_from_numpy(_np_params(), "cpu", torch.float32),
        torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("plan", PLANS)
def test_engine_streams_and_prefill_rung_match_jax_f32(plan):
    """lm_prefill's last-position logits within 1e-4 of their scale, and the
    greedy token streams through Engine + RequestQueue (prompts of 100-128
    tokens bucketed to 128, left padded, a forced partial batch) identical
    to the reference engine's on the same rung."""
    toks = _tokens(1)
    np_params = _np_params()
    jparams = jax.tree.map(jnp.asarray, np_params)
    jcfg, tcfg = _cfgs()
    params = params_from_numpy(np_params, "cpu", torch.float32)
    model = _port_model(plan)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, SMALL["vocab_size"], int(n)).astype(np.int32)
               for n in rng.integers(100, S + 1, 3)]
    with jax_rung(plan), obs.capture() as cap:
        jmodel = j_build_model(jcfg, mode="pallas_interpret")
        _, want = jmodel.prefill(jparams, jnp.asarray(toks),
                                 jmodel.init_cache(B, S + 8))
        jq = JRequestQueue(JEngine(jmodel, jparams, max_len=S + 8), 2,
                           buckets=(S,))
        for uid, p in enumerate(prompts):
            jq.submit(JRequest(uid, p, 4))
        assert jq.flush(force=True) == len(prompts)
    # one traced layer each: lm_prefill and the engine's prefill bucket
    _check_rung(cap, plan, 4)
    want = np.asarray(want, np.float32)
    _, got = model.prefill(params, torch.from_numpy(toks).long(),
                           model.init_cache(B, S + 8))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    tq = RequestQueue(Engine(model, params, max_len=S + 8), 2, buckets=(S,))
    for uid, p in enumerate(prompts):
        tq.submit(Request(uid, p, 4))
    assert tq.flush(force=True) == len(prompts)
    assert sorted(tq.results) == sorted(jq.results)
    for uid in jq.results:
        np.testing.assert_array_equal(tq.results[uid], jq.results[uid])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize("plan", PLANS)
def test_lm_loss_grads_rung_match_jax_f32(plan):
    """lm_loss and every leaf's grad at S = 128, fp32, fp32 masters: the
    loss within 1e-5 relative, each grad within 1e-4 of its leaf's largest
    entry, against jax.grad through the reference's interpret-mode kernels
    on the same rung (its journal, for the one layer its scan traces: the
    rotation kernel for q and k in the forward, again in the recompute of
    the rematerialised block and, with -sin, in the backward; six a layer,
    as the port launches it)."""
    batch = batch_at(DataConfig(vocab_size=SMALL["vocab_size"], seq_len=S,
                                global_batch=B), 0)
    jmodel = j_build_model(_cfgs()[0], mode="pallas_interpret")
    jparams = jax.tree.map(jnp.asarray, _np_params())
    with jax_rung(plan), obs.capture() as cap:
        (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    _check_rung(cap, plan, 6)
    jgrads = {k: np.asarray(v, np.float32) for k, v in _flat(jgrads).items()}
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(_np_params(), "cpu", torch.float32))
    tbatch = {k: torch.from_numpy(v).to(torch.float32 if k == "loss_mask"
                                        else torch.int64)
              for k, v in batch.items()}
    loss, _, grads = loss_and_grads(_port_model(plan), params, tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = {p: g.float().numpy() for (p, _), g in zip(named_leaves(params),
                                                      grads)}
    assert sorted(got) == sorted(jgrads)
    for k, want in jgrads.items():
        err = np.abs(got[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


def _layer_config(style):
    """A bare attention config (no model), as the reference's tests use."""
    return types.SimpleNamespace(
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        rope_style=style, rope_theta=10000.0, norm="rmsnorm",
        attn_logit_softcap=None)


@pytest.mark.parametrize("style", ["partial", "none", "half"])
def test_attention_layer_styles_take_rung_two(style):
    """In kernel mode the 'rope_fused' plan sends a style that cannot ride
    the GEMM store ('partial': rotate the first half of each head; 'none')
    down rung 2, as the reference does, instead of raising; 'half' given
    'norm_fused' takes rung 2 too. The layer's output matches the
    reference's attention_layer on rung 2 within 1e-4 of its scale, and the
    reference's journal shows the norm folded into the GEMMs."""
    cfg = _layer_config(style)
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(5)
    p = {"wqk": rng.standard_normal((d, (h + hkv) * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, hkv * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((h * hd, d)) / np.sqrt(h * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    with jax_rung("norm_fused"), obs.capture() as cap:
        want = j_attention.attention_layer(
            cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            mode="pallas_interpret", prenorm=(jnp.asarray(scale), None))
    assert "model.standalone_norm" not in cap.counters
    assert all("rmsnorm" in e.chain for e in cap.launches
               if e.op == "gemm_fused"), [e.chain for e in cap.launches]
    assert cap.count("gemm_fused") == 2
    assert cap.count("rope") == (2 if style == "half" else 0)
    want = np.asarray(want, np.float32)
    plan = "norm_fused" if style == "half" else "rope_fused"
    got = t_attention.attention_layer(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), mode="kernel",
        prenorm=(torch.from_numpy(scale), None), qkv_plan=plan).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("plan", ["rope_fused", "norm_fused", "unfused"])
@pytest.mark.parametrize("seq", [64, 128])
def test_standalone_rope_routing(monkeypatch, plan, seq):
    """Rungs 2 and 3 hand q and k to the RoPE op (the kernel on the card)
    once each per layer at S >= 128, as the reference launches its kernel;
    shorter sequences, rung 1 and the reference mode use the plain
    rotation."""
    calls = []
    monkeypatch.setattr(t_attention, "rope",
                        lambda *a: calls.append(a[0].shape) or rope(*a))
    toks = torch.from_numpy(_tokens()[:, :seq]).long()
    params = params_from_numpy(_np_params(), "cpu", torch.float32)
    _port_model(plan).forward(params, toks)
    want = 0 if plan == "rope_fused" or seq < 128 else 2 * SMALL["num_layers"]
    assert len(calls) == want, calls
    calls.clear()
    build_model(_cfgs()[1], mode="reference", device="cpu",
                qkv_plan=plan).forward(params, toks)
    assert not calls


def test_build_model_rejects_an_unknown_plan():
    with pytest.raises(ValueError, match="qkv_plan"):
        build_model(_cfgs()[1], mode="kernel", device="cpu",
                    qkv_plan="fused")
