"""The port's gemm_fused on the CPU (its plain version) against the JAX
reference: the jnp oracle ``gemm_fused_ref`` and the Pallas kernel in
interpret mode, over the chains the model's kernel mode launches and the
reference's own chain matrix of what the kernel takes (``tests/
test_kernels.py`` TestEpilogue and TestPrologue: the layernorm prologue
with and without beta; silu, gelu and relu, gated and not), in fp32 and
bf16. Inputs are made with numpy from a seed and handed to both sides.
The chains the kernel still refuses raise, and autograd through a chain
the backward kernels do not take raises in kernel mode while the
reference backward gives ``jax.grad``'s numbers.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the package re-exports a function named ``gemm``: import the module itself
jg = importlib.import_module("repro.kernels.gemm")

from repro_torch.kernels import gemm as tg

M, K, N, HD = 24, 128, 128, 32   # M ragged against every tile size

RMS = dict(norm="rmsnorm")
LN = dict(norm="layernorm")
LN_BETA = dict(norm="layernorm", beta=True)
# the chains of the model's kernel mode (+ the bias variant of rope), then
# the reference's chain matrix of what the kernel takes: name ->
# (epilogue kwargs, prologue kwargs or None)
CHAINS = {
    "qk_rope": (dict(rope=True, head_dim=HD), RMS),
    "qk_rope_bias": (dict(rope=True, head_dim=HD, bias=True), RMS),
    "v_identity": (dict(), RMS),
    "up_silu_gate": (dict(activation="silu", gate=True), RMS),
    "down_residual_scale": (dict(residual=True, scale=True), None),
    # the layernorm prologue (whisper's and bert's q|k, v and up GEMMs)
    "ln": (dict(), LN),
    "ln_beta": (dict(), LN_BETA),
    "ln_beta_bias": (dict(bias=True), LN_BETA),
    "ln_beta_up_gelu": (dict(activation="gelu"), LN_BETA),
    "ln_up_geglu": (dict(activation="gelu", gate=True), LN),
    # every activation, gated and not
    "silu": (dict(activation="silu"), None),
    "gelu": (dict(activation="gelu"), None),
    "relu": (dict(activation="relu"), None),
    "silu_gate": (dict(activation="silu", gate=True), None),
    "gelu_gate": (dict(activation="gelu", gate=True), None),
    "relu_gate": (dict(activation="relu", gate=True), None),
    # the reference matrix's compositions
    "bias_gelu": (dict(bias=True, activation="gelu"), None),
    "bias_silu_residual": (dict(bias=True, activation="silu",
                                residual=True), None),
    "gelu_gate_residual_scale": (dict(activation="gelu", gate=True,
                                      residual=True, scale=True), None),
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
        if pro.get("beta"):
            ops["beta"] = rng.standard_normal(K).astype(np.float32)
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
        jkw["prologue"] = jg.Prologue(**pro)
        tkw["prologue"] = tg.Prologue(**pro)
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


@pytest.mark.parametrize("case", ["layernorm_stats", "stats", "row_scale",
                                  "col_scale", "grad_plain_gelu",
                                  "missing_b2", "extra_bias",
                                  "rope_head_dim"])
def test_gemm_fused_refuses_what_the_kernel_does_not_take(case):
    a, b = torch.zeros(8, 16), torch.zeros(16, 8)
    g = torch.ones(16)
    kw = {
        "layernorm_stats": dict(
            prologue=tg.Prologue(norm="layernorm", precomputed_stats=True),
            gamma=g, mean=torch.zeros(8), rstd=torch.ones(8)),
        "stats": dict(prologue=tg.Prologue(norm="rmsnorm",
                                           precomputed_stats=True),
                      gamma=g, rstd=torch.ones(8)),
        "row_scale": dict(epilogue=tg.Epilogue(scale=True, scale_kind="row"),
                          scale=torch.ones(8, 1)),
        "col_scale": dict(epilogue=tg.Epilogue(scale=True, scale_kind="col"),
                          scale=torch.ones(1, 8)),
        # the backward kernels take gelu' (from the saved preact) but no
        # dscale: a scale that requires grad is refused when recorded
        "grad_plain_gelu": dict(
            epilogue=tg.Epilogue(activation="gelu", scale=True),
            scale=torch.tensor(0.5, requires_grad=True)),
        "missing_b2": dict(epilogue=tg.Epilogue(activation="silu", gate=True)),
        "extra_bias": dict(bias=torch.zeros(8)),
        "rope_head_dim": dict(epilogue=tg.Epilogue(rope=True, head_dim=6),
                              sin=torch.zeros(8, 6), cos=torch.zeros(8, 6)),
    }[case]
    if case.startswith("grad_"):
        a = a.requires_grad_()
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


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2"])
def test_gemm_fused_refuses_fp8_operands(dtype):
    """The reference upcasts fp8 operands inside its kernel; the port's
    kernel takes bf16 only, and the CPU refuses what the card would."""
    if not hasattr(torch, dtype):
        pytest.skip(f"this torch has no {dtype}")
    a = torch.zeros(8, 16).to(getattr(torch, dtype))
    with pytest.raises(NotImplementedError, match="fp8"):
        tg.gemm_fused(a, torch.zeros(16, 8), out_dtype=torch.float32)


# the chains whose backward kernels came after their forward (layernorm's
# transpose with dbeta, gelu' and relu', the non-gated saved preacts)
NO_KERNEL_BACKWARD = ["ln", "ln_beta", "ln_beta_up_gelu", "ln_up_geglu",
                      "silu", "gelu", "relu", "gelu_gate", "relu_gate"]


@pytest.mark.parametrize("chain", NO_KERNEL_BACKWARD)
def test_kernel_backward_refuses_what_it_does_not_take(chain):
    """Autograd through each of these chains records in kernel mode (the
    default) and gives the grads of bwd_mode='reference' (fp32, 1e-5 of
    each grad's largest entry); what the backward kernels still refuse,
    the same chain on precomputed statistics, raises in check_backward."""
    ep_kw, pro, ops = _operands(chain, "float32")
    ta = _torch_args(ops, torch.float32)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (M, N)).astype(np.float32))
    grads = {}
    for mode in ("kernel", "reference"):
        a = ta["a"].clone().requires_grad_()
        kw = dict(epilogue=tg.Epilogue(**ep_kw), out_dtype=torch.float32, **{
            k: v for k, v in ta.items() if k not in ("a", "b")})
        if pro:
            kw["prologue"] = tg.Prologue(**pro)
        out = tg.gemm_fused(a, ta["b"], bwd_mode=mode, **kw)
        assert out.requires_grad
        grads[mode] = torch.autograd.grad((out * w).sum(), a)[0]
    err = (grads["kernel"] - grads["reference"]).abs().max()
    assert err <= 1e-5 * grads["reference"].abs().max()
    stats = tg.Prologue(**dict(pro or {"norm": "rmsnorm"},
                               precomputed_stats=True))
    with pytest.raises(NotImplementedError, match="backward kernel"):
        tg.check_backward(tg.Epilogue(**ep_kw), stats)


@pytest.mark.parametrize("chain", ["ln_beta_up_gelu", "ln_up_geglu",
                                   "bias_gelu", "relu_gate"])
def test_reference_backward_matches_jax_grad(chain):
    """bwd_mode='reference' on the CPU: the grads of sum(w * out) for every
    operand equal jax.grad through the reference's oracle within 1e-5 of
    each grad's largest entry (fp32; sums in another order)."""
    ep_kw, pro, ops = _operands(chain, "float32")
    w = np.random.default_rng(9).standard_normal((M, N)).astype(np.float32)
    names = sorted(k for k in ops if k not in ("scale",))
    jep = jg.Epilogue(**ep_kw)
    jpro = jg.Prologue(**pro) if pro else jg.Prologue()

    def jloss(*args):
        kw = dict(zip(names, args))
        out = jg.gemm_fused_ref(kw.pop("a"), kw.pop("b"), epilogue=jep,
                                prologue=jpro, out_dtype=jnp.float32, **kw)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(ops[k]) for k in names])
    leaves = {k: torch.from_numpy(ops[k]).requires_grad_() for k in names}
    kw = {k: v for k, v in leaves.items() if k not in ("a", "b")}
    if pro:
        kw["prologue"] = tg.Prologue(**pro)
    out = tg.gemm_fused(leaves["a"], leaves["b"],
                        epilogue=tg.Epilogue(**ep_kw), out_dtype=torch.float32,
                        bwd_mode="reference", **kw)
    (out * torch.from_numpy(w)).sum().backward()
    for name, j in zip(names, want):
        j = np.asarray(j)
        got = leaves[name].grad.numpy()
        assert got.shape == j.shape, name
        np.testing.assert_allclose(got, j, rtol=0,
                                   atol=1e-5 * float(np.abs(j).max()),
                                   err_msg=name)
