"""The port's backward on the CPU against the JAX reference: the chain
transpose rules (``Epilogue.transpose_tile``/``operand_grads``,
``Prologue.transpose``, ``gemm_fused_bwd_ref``), the gradients of the
port's ``gemm_fused`` (its backward kernels' plain versions) against
``jax.grad`` through the reference's ``_da_kernel``/``_db_kernel`` in
interpret mode, and the gradients of the port's ``attention`` against
``jax.grad`` through ``_dq_kernel``/``_dkv_kernel`` in interpret mode.
Inputs are made with numpy from a seed and handed to both sides.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the package re-exports a function named ``gemm``: import the module itself
jg = importlib.import_module("repro.kernels.gemm")
from repro.kernels.attention import ops as jattn  # noqa: E402
from repro.kernels.attention.kernel_bwd import \
    flash_attention_bwd as j_flash_bwd  # noqa: E402
from repro.kernels.attention.kernel_fwd import \
    flash_attention_fwd as j_flash_fwd  # noqa: E402
from repro.kernels.gemm.epilogue import _act_grad as j_act_grad  # noqa: E402

from repro_torch.kernels import attention as ta  # noqa: E402
from repro_torch.kernels import gemm as tg  # noqa: E402
from repro_torch.kernels.gemm.epilogue import _act_grad  # noqa: E402

M, K, N, HD = 24, 128, 128, 32   # M ragged against every tile size

# the four chains of llama's kernel mode, plus the bias variant of rope,
# then the layernorm chains of whisper's and bert's (and the activations
# alone and gated): name -> (epilogue kwargs, prologue: False, True
# (rmsnorm), "ln" or "ln_beta" (layernorm without or with beta))
CHAINS = {
    "qk_rope": (dict(rope=True, head_dim=HD), True),
    "qk_rope_bias": (dict(rope=True, head_dim=HD, bias=True), True),
    "v_identity": (dict(), True),
    "up_silu_gate": (dict(activation="silu", gate=True), True),
    "down_residual_scale": (dict(residual=True, scale=True), False),
    "ln_beta_identity": (dict(), "ln_beta"),
    "ln_identity": (dict(), "ln"),
    "ln_beta_gelu": (dict(activation="gelu"), "ln_beta"),
    "ln_gelu": (dict(activation="gelu"), "ln"),
    "ln_beta_relu": (dict(activation="relu"), "ln_beta"),
    "ln_silu": (dict(activation="silu"), "ln"),
    "ln_beta_geglu": (dict(activation="gelu", gate=True), "ln_beta"),
    "ln_beta_residual": (dict(residual=True, scale=True), "ln_beta"),
    "bias_gelu": (dict(activation="gelu", bias=True), False),
}


def _prologue(pkg, pro):
    """The chain's prologue in the JAX package (jg) or the port (tg)."""
    if not pro:
        return pkg.Prologue()
    if pro is True:
        return pkg.Prologue(norm="rmsnorm")
    return pkg.Prologue(norm="layernorm", beta=pro == "ln_beta")


def _operands(chain, seed=0):
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
    if ep_kw.get("rope"):
        ang = rng.uniform(0, 6.3, (M, HD // 2)).astype(np.float32)
        ops["sin"] = np.concatenate([np.sin(ang)] * 2, axis=1)
        ops["cos"] = np.concatenate([np.cos(ang)] * 2, axis=1)
    if pro:
        ops["gamma"] = rng.uniform(0.5, 1.5, K).astype(np.float32)
    if pro == "ln_beta":
        ops["beta"] = (rng.standard_normal(K) * 0.5).astype(np.float32)
    if pro in ("ln", "ln_beta"):
        ops["a"] += 0.5          # a mean the layernorm takes out
    w = rng.standard_normal((M, N)).astype(np.float32)   # the loss weights
    return ep_kw, pro, ops, w


def _tree_max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


# ---------------------------------------------------------------------------
# The transpose rules, on the same arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_act_grad_matches_jax_vjp(act):
    """The hand-derived activation derivatives against the reference's
    jax.vjp ones; fp32, the same formula in another order: 1e-5 relative
    plus 1e-5 (gelu's tanh form sums terms of x^3 ~ 1e2 that cancel)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    want = np.asarray(j_act_grad(act, jnp.asarray(x), jnp.asarray(g)))
    got = _act_grad(act, torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                               err_msg=_by_vector(got, want, 1e-5, 1e-5))


def test_gelu_grad_holds_where_torch_tanh_loses_precision(monkeypatch):
    """ROADMAP C6: test_act_grad_matches_jax_vjp[gelu] failed now and then
    on elements 2048-4095 only, with the bits of MKL's vector tanh in its
    low-accuracy mode (VML_EP, AVX2 branch) on that chunk: torch.tanh runs
    in 2048-element chunks across threads and one worker's chunk lost
    half its bits. Here torch.tanh's second chunk is off by 1e-4 (that
    mode's size); gelu' does not take torch.tanh, so it still matches
    jax.vjp within the same 1e-5 relative plus 1e-5."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    tanh = torch.tanh

    def half_precise(u):
        t = tanh(u)
        return torch.cat([t[:2048], t[2048:] - 1e-4 * torch.sign(t[2048:])])
    monkeypatch.setattr(torch, "tanh", half_precise)
    want = np.asarray(j_act_grad("gelu", jnp.asarray(x), jnp.asarray(g)))
    got = _act_grad("gelu", torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                               err_msg=_by_vector(got, want, 1e-5, 1e-5))


def _by_vector(got, want, rtol, atol, lanes=16) -> str:
    """Where ``got`` misses ``want`` (assert_allclose's rule), grouped by
    aligned ``lanes``-element vectors (a 512-bit register of fp32): the
    wrong elements, the vectors they touch, how many of those are wrong in
    every lane, and the first vectors' wrong lanes. Empty when all hold."""
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    if not bad.any():
        return ""
    per = bad.reshape(-1, lanes).sum(axis=1)
    touched = np.nonzero(per)[0]
    whole = int((per == lanes).sum())
    first = {int(v): np.nonzero(bad[v * lanes:(v + 1) * lanes])[0].tolist()
             for v in touched[:8]}
    return (f"{int(bad.sum())} of {bad.size} wrong, in {len(touched)} of "
            f"{per.size} aligned {lanes}-lane vectors, {whole} of them "
            f"wrong in every lane (whole vectors only: "
            f"{bool(whole * lanes == bad.sum())}); wrong lanes of the first "
            f"vectors {first}")


EPILOGUES = {
    "gate_silu_scale": dict(activation="silu", gate=True, scale=True),
    "gate_gelu": dict(activation="gelu", gate=True),
    "bias_relu_scale": dict(activation="relu", bias=True, scale=True),
    "rope_bias_scale": dict(rope=True, head_dim=HD, bias=True, scale=True),
    "rope_bias": dict(rope=True, head_dim=HD, bias=True),
    "residual_scale": dict(residual=True, scale=True),
}


@pytest.mark.parametrize("name", list(EPILOGUES))
def test_epilogue_transpose_matches_reference(name):
    """transpose_tile and operand_grads (every entry: bias, residual,
    scale, the rope tables from the preact and, without a scale, from the
    output) on the same fp32 arrays; 1e-5 relative, sums in another
    order."""
    kw = EPILOGUES[name]
    rng = np.random.default_rng(2)
    arr = {k: rng.standard_normal((M, N)).astype(np.float32)
           for k in ("g", "preact", "preact2", "out")}
    ang = rng.uniform(0, 6.3, (M, HD // 2)).astype(np.float32)
    extra = {"bias": rng.standard_normal((1, N)).astype(np.float32),
             "scale": np.float32(0.7),
             "sin": np.concatenate([np.sin(ang)] * 2, axis=1),
             "cos": np.concatenate([np.cos(ang)] * 2, axis=1)}
    names = [n for n in ("bias", "scale", "sin", "cos")
             if kw.get(n) or (n in ("sin", "cos") and kw.get("rope"))]
    jk = {n: jnp.asarray(extra[n]) for n in names}
    tk = {n: torch.from_numpy(np.asarray(extra[n])) for n in names}
    jep, tep = jg.Epilogue(**kw), tg.Epilogue(**kw)
    jarr = {k: jnp.asarray(v) for k, v in arr.items()}
    tarr = {k: torch.from_numpy(v) for k, v in arr.items()}
    pre = ("preact", "preact2") if kw.get("gate") else ("preact",)
    jp = [jarr[p] for p in pre]
    tp = [tarr[p] for p in pre]
    want = jep.transpose_tile(jarr["g"], *jp, **jk)
    got = tep.transpose_tile(tarr["g"], *tp, **tk)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    from_out = kw.get("rope") and not kw.get("scale")
    for use_preact in ((True, False) if from_out else (True,)):
        args = (jp if use_preact else [None], tp if use_preact else [None])
        want = jep.operand_grads(jarr["g"], *args[0], out=jarr["out"], **jk)
        got = tep.operand_grads(tarr["g"], *args[1], out=tarr["out"], **tk)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-4, err_msg=k)
    assert tep.needs_saved_preact == jep.needs_saved_preact
    assert tep.saved_accumulators == jep.saved_accumulators
    assert tep.preact_keeps_f32 == jep.preact_keeps_f32


PROLOGUES = {
    "rmsnorm": dict(norm="rmsnorm"),
    "rmsnorm_stats": dict(norm="rmsnorm", precomputed_stats=True),
    "layernorm_beta": dict(norm="layernorm", beta=True),
    "layernorm_beta_stats": dict(norm="layernorm", beta=True,
                                 precomputed_stats=True),
}


@pytest.mark.parametrize("name", list(PROLOGUES))
def test_prologue_transpose_matches_reference(name):
    """Both statistics paths of the norm transpose on the same fp32 rows,
    and grad_names; 1e-5 relative."""
    kw = PROLOGUES[name]
    rng = np.random.default_rng(3)
    dan = rng.standard_normal((M, K)).astype(np.float32)
    a = (rng.standard_normal((M, K)) * 2 + 0.5).astype(np.float32)
    ops = {"gamma": rng.uniform(0.5, 1.5, (1, K)).astype(np.float32)}
    if kw.get("beta"):
        ops["beta"] = rng.standard_normal((1, K)).astype(np.float32)
    jpro, tpro = jg.Prologue(**kw), tg.Prologue(**kw)
    if kw.get("precomputed_stats"):
        stats = jpro.compute_stats(jnp.asarray(a))
        ops.update({k: np.array(v) for k, v in stats.items()})
    want = jpro.transpose(jnp.asarray(dan), jnp.asarray(a),
                          **{k: jnp.asarray(v) for k, v in ops.items()})
    got = tpro.transpose(torch.from_numpy(dan), torch.from_numpy(a),
                         **{k: torch.from_numpy(v) for k, v in ops.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert tpro.grad_names() == jpro.grad_names()


@pytest.mark.parametrize("chain", list(CHAINS))
def test_gemm_fused_bwd_ref_matches_reference(chain):
    """The hand-written chain-transpose oracle on the same fp32 operands
    (a tensor scale, so dscale is compared too); 1e-5 of each grad's
    largest entry."""
    ep_kw, pro, ops, w = _operands(chain)
    if ep_kw.get("scale"):
        ops["scale"] = np.float32(0.75)
    kw = dict(epilogue=jg.Epilogue(**ep_kw), prologue=_prologue(jg, pro))
    tkw = dict(epilogue=tg.Epilogue(**ep_kw), prologue=_prologue(tg, pro))
    jops = {k: jnp.asarray(v) for k, v in ops.items()}
    tops = {k: torch.tensor(v) for k, v in ops.items()}
    want = jg.gemm_fused_bwd_ref(jops.pop("a"), jops.pop("b"), jnp.asarray(w),
                                 **kw, **jops)
    got = tg.gemm_fused_bwd_ref(tops.pop("a"), tops.pop("b"),
                                torch.from_numpy(w), **tkw, **tops)
    for g, j in zip(got[:2], want[:2]):
        assert _tree_max_err(g.numpy(), j) <= 1e-5 * np.abs(j).max()
    assert sorted(got[2]) == sorted(want[2])
    for k, j in want[2].items():
        g = got[2][k].numpy().reshape(np.shape(j))
        assert _tree_max_err(g, j) <= 1e-5 * max(1.0, np.abs(j).max()), k


# ---------------------------------------------------------------------------
# gemm_fused grads: the port's plain backward vs the reference's kernels
# ---------------------------------------------------------------------------

def _jax_grads(chain, ops, w, dtype, mode, bwd_mode):
    ep_kw, pro, _, _ = _operands(chain)
    diff = [k for k in ops if k not in ("sin", "cos")]

    def loss(*vals):
        kw = dict(zip(diff, vals))
        kw.update({k: jnp.asarray(ops[k]) for k in ("sin", "cos") if k in ops})
        if ep_kw.get("scale"):
            kw["scale"] = jnp.float32(0.75)
        a, b = kw.pop("a"), kw.pop("b")
        out = jg.gemm_fused(
            a, b, epilogue=jg.Epilogue(**ep_kw), prologue=_prologue(jg, pro),
            mode=mode, bwd_mode=bwd_mode, out_dtype=dtype, **kw)
        return jnp.sum(out.astype(jnp.float32) * w)

    vals = [jnp.asarray(ops[k]).astype(dtype) for k in diff]
    grads = jax.grad(loss, argnums=tuple(range(len(diff))))(*vals)
    return {k: np.asarray(g, np.float32) for k, g in zip(diff, grads)}


def _port_grads(chain, ops, w, dtype, bwd_mode):
    ep_kw, pro, _, _ = _operands(chain)
    t = {k: torch.from_numpy(v).to(dtype).requires_grad_()
         for k, v in ops.items() if k not in ("sin", "cos")}
    kw = {k: torch.from_numpy(ops[k]) for k in ("sin", "cos") if k in ops}
    if ep_kw.get("scale"):
        kw["scale"] = 0.75
    a, b = t["a"], t["b"]
    out = tg.gemm_fused(
        a, b, epilogue=tg.Epilogue(**ep_kw), prologue=_prologue(tg, pro),
        out_dtype=dtype, bwd_mode=bwd_mode,
        **{k: v for k, v in t.items() if k not in ("a", "b")}, **kw)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return {k: v.grad.float().numpy() for k, v in t.items()}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_gemm_grads_match_jax_kernels_f32(chain):
    """fp32 on both sides: the port's kernel backward (plain versions on
    the CPU) against jax.grad through _da_kernel/_db_kernel in interpret
    mode; the same fp32 math summed in another order, 2e-6 of each grad's
    largest entry (measured: at most 5.3e-7)."""
    _, _, ops, w = _operands(chain)
    want = _jax_grads(chain, ops, w, jnp.float32, "pallas_interpret",
                      "kernel")
    got = _port_grads(chain, ops, w, torch.float32, "kernel")
    assert sorted(got) == sorted(want)
    for k in want:
        assert _tree_max_err(got[k], want[k]) <= 2e-6 * np.abs(want[k]).max(), k


@pytest.mark.parametrize("chain", list(CHAINS))
def test_gemm_grads_bf16_track_the_f32_truth(chain):
    """bf16: per leaf, the port's kernel backward is no further from the
    fp32 truth than 2x the oracle backward (bwd_mode='reference') + 1e-3,
    the reference's own criterion (tests/test_backward.py)."""
    _, _, ops, w = _operands(chain)
    truth = _port_grads(chain, ops, w, torch.float32, "reference")
    kern = _port_grads(chain, ops, w, torch.bfloat16, "kernel")
    orac = _port_grads(chain, ops, w, torch.bfloat16, "reference")
    for k in truth:
        k_err = _tree_max_err(kern[k], truth[k])
        o_err = _tree_max_err(orac[k], truth[k])
        assert k_err <= 2.0 * o_err + 1e-3, (k, k_err, o_err)


def test_bwd_modes():
    """'reference' is autograd through the oracle, taken only when asked
    for (argument or default_bwd_mode); 'auto' takes the route that
    ``core.autotune.select_bwd_mode`` names; a scale or rope table that
    requires grad raises; on fp32 the two backward modes agree to 1e-5 of
    each grad's largest entry."""
    _, _, ops, w = _operands("up_silu_gate")
    kern = _port_grads("up_silu_gate", ops, w, torch.float32, "kernel")
    with tg.default_bwd_mode("reference"):
        orac = _port_grads("up_silu_gate", ops, w, torch.float32, None)
    for k in kern:
        assert _tree_max_err(kern[k], orac[k]) <= 1e-5 * np.abs(orac[k]).max()
    from repro_torch.core import autotune
    route = autotune.select_bwd_mode(
        M, N, K, dtype=torch.float32,
        epilogue=tg.Epilogue(activation="silu", gate=True))
    auto = _port_grads("up_silu_gate", ops, w, torch.float32, "auto")
    want = kern if route == "kernel" else orac
    for k in kern:
        assert _tree_max_err(auto[k], want[k]) == 0.0
    with pytest.raises(ValueError, match="unknown bwd_mode"):
        _port_grads("up_silu_gate", ops, w, torch.float32, "fast")
    a = torch.ones(8, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tg.gemm_fused(a, torch.ones(16, 8),
                      epilogue=tg.Epilogue(residual=True, scale=True),
                      residual=torch.ones(8, 8),
                      scale=torch.tensor(0.5, requires_grad=True),
                      out_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tg.gemm_fused(a, torch.ones(16, 8),
                      epilogue=tg.Epilogue(rope=True, head_dim=8),
                      sin=torch.zeros(8, 8, requires_grad=True),
                      cos=torch.ones(8, 8), out_dtype=torch.float32)


def test_kernel_backward_saves_preacts_for_the_activation_only():
    """The forward keeps the raw accumulators of an activation chain (two
    for the gated one: act' needs them), and none for the scale chain: the
    port's scale is a number without a gradient (the reference keeps fp32
    ones for dscale)."""
    assert tg.kernel_saves(tg.Epilogue(activation="silu", gate=True)) == 2
    assert tg.kernel_saves(tg.Epilogue(activation="gelu")) == 1
    assert tg.kernel_saves(tg.Epilogue(activation="relu", bias=True)) == 1
    assert tg.kernel_saves(tg.Epilogue(residual=True, scale=True)) == 0
    assert tg.kernel_saves(tg.Epilogue(rope=True, head_dim=64)) == 0
    assert tg.Epilogue(residual=True, scale=True).saved_accumulators == 1


# every chain the forward kernel takes: (norm, beta) x activation x gate
_TAKEN = [(norm, beta, act, gate)
          for norm, beta in (("none", False), ("rmsnorm", False),
                             ("layernorm", False), ("layernorm", True))
          for act in ("none", "silu", "gelu", "relu")
          for gate in ((False, True) if act != "none" else (False,))]


@pytest.mark.parametrize("norm,beta,act,gate", _TAKEN)
def test_check_backward_takes_every_forward_chain(norm, beta, act, gate):
    """check_backward raises on none of the chains the forward kernel
    takes, and both backward modes give the same fp32 grads there (the
    reference mode is autograd through the oracle): 1e-4 of each grad's
    largest entry."""
    ep = tg.Epilogue(activation=act, gate=gate)
    pro = tg.Prologue(norm=norm, beta=beta)
    tg.check_backward(ep, pro)
    tg.check_chain(ep, pro)
    rng = np.random.default_rng(11)
    ops = {"a": rng.standard_normal((M, K)) + 0.3,
           "b": rng.standard_normal((K, N)) / np.sqrt(K)}
    if gate:
        ops["b2"] = rng.standard_normal((K, N)) / np.sqrt(K)
    if norm != "none":
        ops["gamma"] = rng.uniform(0.5, 1.5, K)
    if beta:
        ops["beta"] = rng.standard_normal(K) * 0.5
    w = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32))
    grads = {}
    for mode in ("kernel", "reference"):
        t = {k: torch.from_numpy(v.astype(np.float32)).requires_grad_()
             for k, v in ops.items()}
        out = tg.gemm_fused(t["a"], t["b"], epilogue=ep, prologue=pro,
                            out_dtype=torch.float32, bwd_mode=mode,
                            **{k: v for k, v in t.items()
                               if k not in ("a", "b")})
        (out * w).sum().backward()
        grads[mode] = {k: v.grad.numpy() for k, v in t.items()}
    for k, want in grads["reference"].items():
        err = _tree_max_err(grads["kernel"][k], want)
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("chain,match", [
    ((tg.Epilogue(), tg.Prologue(norm="rmsnorm", precomputed_stats=True)),
     "dmean/drstd"),
    ((tg.Epilogue(activation="gelu"),
      tg.Prologue(norm="layernorm", beta=True, precomputed_stats=True)),
     "dmean/drstd"),
    ((tg.Epilogue(scale=True, scale_kind="row"), tg.Prologue()),
     "row scales"),
    ((tg.Epilogue(scale=True, scale_kind="col", activation="relu"),
      tg.Prologue(norm="layernorm")), "col scales"),
])
def test_check_backward_refuses_what_the_kernels_do_not_take(chain, match):
    """Each refusal has its own message: the precomputed-statistics
    prologue's dmean/drstd and the row or column scale's dscale."""
    with pytest.raises(NotImplementedError, match=match):
        tg.check_backward(*chain)


# ---------------------------------------------------------------------------
# attention grads: the port's plain backward vs the reference's kernels
# ---------------------------------------------------------------------------

ATTN = {
    "gqa2_causal": (4, 2, dict(causal=True)),
    "gqa4_causal": (8, 2, dict(causal=True)),
    "gqa2_window": (4, 2, dict(causal=True, window=24)),
    "gqa4_softcap": (4, 1, dict(causal=True, softcap=5.0)),
}
B, S, D = 1, 64, 64


def _attn_inputs(name):
    h, hkv, kw = ATTN[name]
    rng = np.random.default_rng(4)
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((B, h, S, D), (B, hkv, S, D), (B, hkv, S, D),
                                (B, h, S, D)))
    return q, k, v, w, kw


@pytest.mark.parametrize("name", list(ATTN))
def test_attention_grads_match_jax_kernels(name):
    """fp32: jax.grad through _dq_kernel/_dkv_kernel (interpret mode, the
    group summed by the reference's caller) against the port's attention
    backward (the kernels' plain version, the group summed inside); 2e-6
    of each grad's largest entry (measured: at most 4e-7)."""
    q, k, v, w, kw = _attn_inputs(name)

    def loss(q, k, v):
        return jnp.sum(jattn.attention(q, k, v, mode="pallas_interpret",
                                       **kw) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (ta.attention(tq, tk, tv, **kw) * torch.from_numpy(w)).sum().backward()
    for j, t in zip(want, (tq, tk, tv)):
        j = np.asarray(j)
        assert _tree_max_err(t.grad.numpy(), j) <= 2e-6 * np.abs(j).max()


def test_flash_bwd_ref_matches_the_reference_passes():
    """The two passes' plain version against the reference's
    flash_attention_bwd (interpret mode) on the same q, k, v, out, lse and
    dO, the per-query-head dk/dv summed over each group; fp32, 2e-6 of the
    largest entry."""
    q, k, v, w, kw = _attn_inputs("gqa4_causal")
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = j_flash_fwd(jq, jk, jv, causal=True)
    do = jnp.asarray(w)
    dq, dk, dv = j_flash_bwd(jq, jk, jv, out, lse, do, causal=True)
    group = q.shape[1] // k.shape[1]
    dk = np.asarray(dk).reshape(B, k.shape[1], group, S, D).sum(axis=2)
    dv = np.asarray(dv).reshape(B, k.shape[1], group, S, D).sum(axis=2)
    got = ta.flash_attention_bwd_ref(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, w)),
        causal=True)
    for g, j in zip(got, (np.asarray(dq), dk, dv)):
        assert _tree_max_err(g.numpy(), j) <= 2e-6 * np.abs(j).max()


def test_attention_bf16_tracks_the_f32_truth():
    """bf16 (p and ds rounded before their products): per input, the
    kernels' plain backward is no further from the fp32 truth than 2x the
    autograd of the bf16 oracle + 1e-3."""
    q, k, v, w, kw = _attn_inputs("gqa2_window")

    def grads(fn, dtype):
        t = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
        (fn(*t, **kw).float() * torch.from_numpy(w)).sum().backward()
        return [x.grad.float().numpy() for x in t]

    truth = grads(ta.attention_ref, torch.float32)
    kern = grads(ta.attention, torch.bfloat16)
    orac = grads(ta.attention_ref, torch.bfloat16)
    for kk, oo, tt in zip(kern, orac, truth):
        assert _tree_max_err(kk, tt) <= 2 * _tree_max_err(oo, tt) + 1e-3
    with pytest.raises(NotImplementedError, match="sinks"):
        ta.attention(*(torch.zeros(1, 2, 8, 64, requires_grad=True)
                       for _ in range(3)), sinks=torch.zeros(2))
