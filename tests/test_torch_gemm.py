"""The port's gemm_fused on the CPU (its plain version) against the JAX
reference: the jnp oracle ``gemm_fused_ref`` and the Pallas kernel in
interpret mode, over the chains the model's kernel mode launches, in fp32
and bf16. Inputs are made with numpy from a seed and handed to both sides.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the package re-exports a function named ``gemm``: import the module itself
jg = importlib.import_module("repro.kernels.gemm")

from repro_torch.kernels import gemm as tg

M, K, N, HD = 24, 128, 128, 32   # M ragged against every tile size

# the four chains of the model's kernel mode (+ the bias variant of rope):
# name -> (epilogue kwargs, rmsnorm prologue?)
CHAINS = {
    "qk_rope": (dict(rope=True, head_dim=HD), True),
    "qk_rope_bias": (dict(rope=True, head_dim=HD, bias=True), True),
    "v_identity": (dict(), True),
    "up_silu_gate": (dict(activation="silu", gate=True), True),
    "down_residual_scale": (dict(residual=True, scale=True), False),
}

# fp32: the same fp32 math on both sides, sums in another order; bf16: the
# output rounds to bf16 (2^-8 relative) and a normed A element may round to
# a neighbouring bf16 value, so allow 2^-6 relative plus 2% of the output's
# RMS for entries near zero.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -6, 2e-2)}


def _operands(chain, dtype, seed=0):
    ep_kw, pro = CHAINS[chain]
    rng = np.random.default_rng(seed)
    ops = {"a": rng.standard_normal((M, K)).astype(np.float32),
           "b": (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)}
    if ep_kw.get("gate"):
        ops["b2"] = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    if ep_kw.get("bias"):
        ops["bias"] = rng.standard_normal(N).astype(np.float32)
    if ep_kw.get("residual"):
        ops["residual"] = rng.standard_normal((M, N)).astype(np.float32)
    if ep_kw.get("scale"):
        ops["scale"] = np.float32(0.75)
    if ep_kw.get("rope"):
        ang = rng.uniform(0, 6.3, (M, HD // 2)).astype(np.float32)
        ops["sin"] = np.concatenate([np.sin(ang)] * 2, axis=1)
        ops["cos"] = np.concatenate([np.cos(ang)] * 2, axis=1)
    if pro:
        ops["gamma"] = rng.uniform(0.5, 1.5, K).astype(np.float32)
    return ep_kw, pro, ops


def _jax_args(ops, dtype):
    out = {}
    for k, v in ops.items():
        if k in ("sin", "cos", "scale"):
            out[k] = jnp.asarray(v)
        else:
            out[k] = jnp.asarray(v).astype(dtype)
    return out


def _torch_args(ops, dtype):
    out = {}
    for k, v in ops.items():
        if k == "scale":
            out[k] = float(v)
        elif k in ("sin", "cos"):
            out[k] = torch.from_numpy(v)
        else:
            out[k] = torch.from_numpy(v).to(dtype)
    return out


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    rtol, rms_frac = TOL[dtype]
    atol = rms_frac * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_gemm_fused_matches_jax(chain, dtype):
    ep_kw, pro, ops = _operands(chain, dtype)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ja, ta = _jax_args(ops, jdt), _torch_args(ops, tdt)
    jep, tep = jg.Epilogue(**ep_kw), tg.Epilogue(**ep_kw)
    jkw = {k: v for k, v in ja.items() if k not in ("a", "b")}
    tkw = {k: v for k, v in ta.items() if k not in ("a", "b")}
    if pro:
        jkw["prologue"] = jg.Prologue(norm="rmsnorm")
        tkw["prologue"] = tg.Prologue(norm="rmsnorm")
    want_ref = jg.gemm_fused_ref(ja["a"], ja["b"], epilogue=jep,
                                 out_dtype=jdt, **jkw)
    want_kernel = jg.gemm_fused(ja["a"], ja["b"], epilogue=jep, out_dtype=jdt,
                                mode="pallas_interpret", **jkw)
    got = tg.gemm_fused(ta["a"], ta["b"], epilogue=tep, out_dtype=tdt, **tkw)
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    _assert_close(got.float().numpy(), want_ref.astype(jnp.float32), dtype)
    _assert_close(got.float().numpy(), want_kernel.astype(jnp.float32), dtype)


def test_gemm_fused_plain_version_is_the_cpu_path():
    ep_kw, pro, ops = _operands("up_silu_gate", "float32")
    ta = _torch_args(ops, torch.float32)
    kw = dict(epilogue=tg.Epilogue(**ep_kw), prologue=tg.Prologue(norm="rmsnorm"),
              b2=ta["b2"], gamma=ta["gamma"], out_dtype=torch.float32)
    got = tg.gemm_fused(ta["a"], ta["b"], **kw)
    want = tg.gemm_fused_ref(ta["a"], ta["b"], **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["layernorm", "stats", "row_scale",
                                  "plain_silu", "gelu_gate", "missing_b2",
                                  "extra_bias", "rope_head_dim"])
def test_gemm_fused_refuses_what_the_kernel_does_not_take(case):
    a, b = torch.zeros(8, 16), torch.zeros(16, 8)
    g = torch.ones(16)
    kw = {
        "layernorm": dict(prologue=tg.Prologue(norm="layernorm"), gamma=g),
        "stats": dict(prologue=tg.Prologue(norm="rmsnorm",
                                           precomputed_stats=True),
                      gamma=g, rstd=torch.ones(8)),
        "row_scale": dict(epilogue=tg.Epilogue(scale=True, scale_kind="row"),
                          scale=torch.ones(8, 1)),
        "plain_silu": dict(epilogue=tg.Epilogue(activation="silu")),
        "gelu_gate": dict(epilogue=tg.Epilogue(activation="gelu", gate=True),
                          b2=b),
        "missing_b2": dict(epilogue=tg.Epilogue(activation="silu", gate=True)),
        "extra_bias": dict(bias=torch.zeros(8)),
        "rope_head_dim": dict(epilogue=tg.Epilogue(rope=True, head_dim=6),
                              sin=torch.zeros(8, 6), cos=torch.zeros(8, 6)),
    }[case]
    with pytest.raises((ValueError, NotImplementedError)):
        tg.gemm_fused(a, b, **kw)


def test_epilogue_spec_validation_matches_reference():
    for kw in (dict(gate=True), dict(gate=True, activation="silu", bias=True),
               dict(rope=True), dict(rope=True, head_dim=3),
               dict(head_dim=8), dict(scale_kind="row")):
        with pytest.raises(ValueError):
            jg.Epilogue(**kw)
        with pytest.raises(ValueError):
            tg.Epilogue(**kw)
    for kw in (dict(rope=True, head_dim=64, bias=True),
               dict(activation="silu", gate=True),
               dict(residual=True, scale=True)):
        assert jg.Epilogue(**kw).describe() == tg.Epilogue(**kw).describe()
        assert (jg.Epilogue(**kw).operand_names()
                == tg.Epilogue(**kw).operand_names())
