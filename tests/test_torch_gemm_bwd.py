"""The GEMM backward's operand pass and its checks, on the CPU.

The backward runs as three launches on the card: the operand pass
(``csrc/gemm_bwd_g.cu``, plain version :func:`gemm_bwd_g_ref`), then dA and
dB on the Hopper mainloop. Here: the operand pass's plain version followed by
the two plain products gives :func:`gemm_bwd_da_ref` and
:func:`gemm_bwd_db_ref` bit for bit, for every chain the kernels take; its
streams and normalised A agree with the JAX package's ``transpose_tile`` and
``Prologue.apply`` on the same fp32 inputs; and the checks that guard the
TMA operands and the shapes refuse what the kernels do not take.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro_torch.kernels.gemm import (Epilogue, Prologue, gemm_bwd_da_ref,
                                      gemm_bwd_db_ref, gemm_bwd_g_ref)
from repro_torch.kernels.gemm import backward as bwd

jg = importlib.import_module("repro.kernels.gemm")

# the chains of the card tests' BWD_CHAINS (tests/test_torch_cuda.py):
# name -> (epilogue kwargs, prologue: False, True (rmsnorm), "ln" or
# "ln_beta" (layernorm without or with beta))
BWD_CHAINS = {
    "rope_bias": (dict(rope=True, head_dim=64, bias=True), True),
    "rope_128": (dict(rope=True, head_dim=128), True),
    "identity_norm": (dict(), True),
    "identity": (dict(), False),
    "silu_gate_norm": (dict(activation="silu", gate=True), True),
    "residual_scale": (dict(residual=True, scale=True), False),
    "bias": (dict(bias=True), False),
    "ln_beta": (dict(), "ln_beta"),
    "ln": (dict(), "ln"),
    "ln_beta_gelu": (dict(activation="gelu"), "ln_beta"),
    "ln_relu": (dict(activation="relu"), "ln"),
    "ln_beta_silu": (dict(activation="silu"), "ln_beta"),
    "ln_geglu": (dict(activation="gelu", gate=True), "ln_beta"),
    "ln_beta_residual": (dict(residual=True, scale=True), "ln_beta"),
    "relu_gate": (dict(activation="relu", gate=True), False),
    "bias_gelu_scale": (dict(activation="gelu", bias=True, scale=True),
                        False),
}
# (M, K, N): M ragged against the 64-row blocks of the pass, and across them
SHAPES = [(24, 128, 256), (136, 64, 128)]


def _operands(chain, m, k, n, dtype):
    """Seeded operands of one chain, as the backward receives them: a, b,
    g, the saved preacts (the rounded raw products of an activation
    chain), the forward's row statistics (rstd, or layernorm's (2, M) mean
    and rstd) and the chain's extras."""
    ep_kw, norm = BWD_CHAINS[chain]
    rng = np.random.default_rng(m * 7 + k + n)

    def rnd(*shape, std=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32)).to(dtype)

    a, b, g = rnd(m, k) + 0.5, rnd(k, n, std=k ** -0.5), rnd(m, n)
    kw = dict(epilogue=Epilogue(**ep_kw), prologue=Prologue())
    if ep_kw.get("gate"):
        kw["b2"] = rnd(k, n, std=k ** -0.5)
    if ep_kw.get("bias"):
        kw["bias"] = rnd(n)
    if ep_kw.get("scale"):
        kw["scale"] = 0.5
    if ep_kw.get("rope"):
        hd = ep_kw["head_dim"]
        ang = torch.from_numpy(rng.uniform(0, 6.3, (m, hd // 2))
                               .astype(np.float32))
        kw["sin"] = torch.cat([ang.sin()] * 2, dim=1)
        kw["cos"] = torch.cat([ang.cos()] * 2, dim=1)
    rstd = None
    an = a.float()
    if norm:
        ln = norm in ("ln", "ln_beta")
        pro = Prologue(norm="layernorm" if ln else "rmsnorm",
                       beta=norm == "ln_beta")
        kw["prologue"] = pro
        kw["gamma"] = (1 + 0.1 * rnd(k).float()).to(dtype)
        if pro.beta:
            kw["beta"] = rnd(k, std=0.5)
        st = pro.compute_stats(a)
        stats = {x: v for x, v in st.items()}
        rstd = (torch.stack([st["mean"].reshape(-1), st["rstd"].reshape(-1)])
                if ln else st["rstd"].reshape(-1))
        an = pro.apply(a.float(), gamma=kw["gamma"].float(),
                       beta=kw["beta"].float() if pro.beta else None,
                       **stats).to(dtype).float()
    preacts = tuple((an @ w.float()).to(dtype)
                    for w in (b, kw.get("b2"))[:kw["epilogue"].n_accumulators]
                    if kw["epilogue"].activation != "none")
    return a, b, g, rstd, preacts, kw


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("chain", sorted(BWD_CHAINS))
def test_operand_pass_then_products_is_the_plain_backward(chain, m, k, n):
    """gemm_bwd_g_ref, then dAn = gbar @ [B | B2]ᵀ (and the norm
    transpose, dgamma and dbeta) and [dB | dB2] = An_ᵀ @ gbar from its
    transposed outputs, equal gemm_bwd_da_ref and gemm_bwd_db_ref bit for
    bit: the same fp32 values contracted in the same layouts. dbias, summed
    from the 64-row partials instead of in one column sum, within 1e-5.
    The dA plain version at the forward's statistics (what the dA launch
    reads) within 1e-5 of it at recomputed ones."""
    a, b, g, rstd, preacts, kw = _operands(chain, m, k, n, torch.bfloat16)
    ep, pro = kw["epilogue"], kw["prologue"]
    ops = gemm_bwd_g_ref(a, g, rstd=rstd, preacts=preacts,
                         **{x: v for x, v in kw.items() if x != "b2"})
    n2 = 2 * n if ep.gate else n
    assert ops["gbar"].shape == (m, n2)
    assert torch.equal(ops["gbar_t"], ops["gbar"].T)
    assert ops["a_t"].shape == (k, m)
    # every operand the tensor cores read is a bf16 value
    for name in ("gbar", "gbar_t", "a_t"):
        assert torch.equal(ops[name], ops[name].to(torch.bfloat16).float())

    f32 = torch.float32
    gbar = ops["gbar"]
    dan = gbar[:, :n].contiguous() @ b.to(f32).T
    if ep.gate:
        dan = dan + gbar[:, n:].contiguous() @ kw["b2"].to(f32).T
    dbeta = None
    if pro.is_identity:
        da, dgamma = dan.to(a.dtype), None
    else:
        tr = pro.transpose(dan, a.to(f32),
                           gamma=kw["gamma"].to(f32).reshape(1, -1))
        da, dgamma = tr["da"].to(a.dtype), tr["dgamma"].reshape(-1)
        if pro.beta:
            dbeta = tr["dbeta"].reshape(-1)
    an = ops["a_t"].T.contiguous()
    gt = ops["gbar_t"]
    db = (an.T @ gt[:n].T.contiguous()).to(b.dtype)
    db2 = (an.T @ gt[n:].T.contiguous()).to(b.dtype) if ep.gate else None

    want_da, want_dgamma, want_dbeta = gemm_bwd_da_ref(
        a, b, g, preacts=preacts, **kw)
    want_db, want_db2, want_dbias = gemm_bwd_db_ref(a, b, g, rstd=rstd,
                                                    preacts=preacts, **kw)
    assert torch.equal(da, want_da)
    if pro.beta:
        assert torch.equal(dbeta, want_dbeta)
    else:
        assert want_dbeta is None
    if rstd is not None:
        saved = gemm_bwd_da_ref(a, b, g, preacts=preacts, rstd=rstd, **kw)
        for x, y in zip(saved, (want_da, want_dgamma, want_dbeta)):
            if y is not None:
                torch.testing.assert_close(x.float(), y.float(), rtol=1e-2,
                                           atol=1e-5 * y.float().abs().max())
    assert torch.equal(db, want_db)
    if ep.gate:
        assert torch.equal(db2, want_db2)
    if dgamma is not None:
        assert torch.equal(dgamma, want_dgamma)
    if ep.bias:
        assert ops["dbias_part"].shape == (-(-m // 64), n)
        torch.testing.assert_close(ops["dbias_part"].sum(dim=0), want_dbias,
                                   rtol=1e-5, atol=1e-5)
    else:
        assert ops["dbias_part"] is None


@pytest.mark.parametrize("chain", sorted(BWD_CHAINS))
def test_operand_pass_matches_the_reference_transpose(chain):
    """On fp32 inputs (no rounding) the operand pass's streams are the JAX
    package's Epilogue.transpose_tile and its A the reference Prologue's
    normalised A; 1e-5 relative."""
    m, k, n = SHAPES[0]
    a, b, g, rstd, preacts, kw = _operands(chain, m, k, n, torch.float32)
    ep_kw, norm = BWD_CHAINS[chain]
    ops = gemm_bwd_g_ref(a, g, rstd=rstd, preacts=preacts,
                         **{x: v for x, v in kw.items() if x != "b2"})
    jkw = {x: jnp.asarray(kw[x].numpy()) for x in ("sin", "cos")
           if x in kw}
    if "bias" in kw:
        jkw["bias"] = jnp.asarray(kw["bias"].numpy().reshape(1, -1))
    if "scale" in kw:
        jkw["scale"] = kw["scale"]
    streams = jg.Epilogue(**ep_kw).transpose_tile(
        jnp.asarray(g.numpy()), *[jnp.asarray(p.numpy()) for p in preacts],
        **jkw)
    want = np.asarray(streams["g_acc"])
    if ep_kw.get("gate"):
        want = np.concatenate([want, np.asarray(streams["g_acc2"])], axis=1)
    np.testing.assert_allclose(ops["gbar"].numpy(), want, rtol=1e-5,
                               atol=1e-5)
    want_a = a.numpy()
    if norm:
        pro = kw["prologue"]
        stats = ({"mean": rstd[0], "rstd": rstd[1]}
                 if pro.norm == "layernorm" else {"rstd": rstd})
        jkw = {x: jnp.asarray(v.numpy().reshape(-1, 1))
               for x, v in stats.items()}
        if pro.beta:
            jkw["beta"] = jnp.asarray(kw["beta"].numpy().reshape(1, -1))
        want_a = np.asarray(jg.Prologue(norm=pro.norm, beta=pro.beta).apply(
            jnp.asarray(a.numpy()),
            gamma=jnp.asarray(kw["gamma"].numpy().reshape(1, -1)), **jkw))
    np.testing.assert_allclose(ops["a_t"].numpy(), want_a.T, rtol=1e-5,
                               atol=1e-6)
    if ep_kw.get("bias"):
        np.testing.assert_allclose(ops["dbias_part"].sum(dim=0).numpy(),
                                   np.asarray(streams["g_bias"]).sum(axis=0),
                                   rtol=1e-5, atol=1e-4)


def test_tma_operand_check_accepts_the_operand_pass_buffers():
    """The buffers the wrapper allocates pass: gbar and its second half,
    the padded transposes at a ragged M."""
    m, n, k = 4, 136, 264
    ld_t = bwd.transposed_stride(m)
    gbar = torch.empty((m, 2 * n), dtype=torch.bfloat16)
    assert bwd.check_tma_operand(gbar, "gbar") == gbar.data_ptr()
    assert bwd.check_tma_operand(gbar, "gbar2", n) == gbar.data_ptr() + 2 * n
    for rows in (2 * n, k):
        bwd.check_tma_operand(torch.empty((rows, ld_t), dtype=torch.bfloat16),
                              "transposed")


@pytest.mark.parametrize("case", ["misaligned", "row_stride", "strided",
                                  "column_offset", "one_dim"])
def test_tma_operand_check_refuses(case):
    """A view whose base is not 16-byte aligned, a row stride that is not
    a multiple of 16 bytes, a non-contiguous view, a column offset off the
    16-byte grid and a 1-D tensor are all refused before any launch."""
    bf16 = torch.bfloat16
    col0 = 0
    if case == "misaligned":
        t = torch.empty(8 * 64 + 1, dtype=bf16)[1:].view(8, 64)
        assert t.data_ptr() % 16
    elif case == "row_stride":
        t = torch.empty((8, 12), dtype=bf16)          # 24-byte rows
    elif case == "strided":
        t = torch.empty((64, 64), dtype=bf16).T
    elif case == "column_offset":
        t, col0 = torch.empty((8, 64), dtype=bf16), 4  # 8 bytes in
    else:
        t = torch.empty(64, dtype=bf16)
    with pytest.raises(ValueError, match="TMA operand"):
        bwd.check_tma_operand(t, "x", col0)


@pytest.mark.parametrize("epilogue,n,k,ok", [
    (Epilogue(), 128, 64, True),
    (Epilogue(), 132, 64, False),
    (Epilogue(), 128, 68, False),
    (Epilogue(rope=True, head_dim=64), 192, 64, True),
    (Epilogue(rope=True, head_dim=24), 96, 64, False),
    (Epilogue(rope=True, head_dim=64), 96, 64, False),
])
def test_shape_rules(epilogue, n, k, ok):
    """N and K multiples of 8; a rope head_dim a multiple of 16 that
    divides N: anything else is a ValueError."""
    if ok:
        bwd.check_shapes(epilogue, n, k)
    else:
        with pytest.raises(ValueError):
            bwd.check_shapes(epilogue, n, k)


@pytest.mark.parametrize("m,want", [(1, 8), (4, 8), (8, 8), (200, 200),
                                    (4097, 4104)])
def test_transposed_stride_pads_to_16_bytes(m, want):
    assert bwd.transposed_stride(m) == want
    assert bwd.transposed_stride(m) * 2 % 16 == 0


@pytest.mark.parametrize("m,n,want", [
    (4096, 2048, 256),    # dA of every training GEMM: 256 tiles, 2 rounds
    (2048, 16384, 256),   # dB of the SwiGLU up-projection
    (8192, 2048, 256),    # dB of the down projection
    (2048, 2560, 128),    # dB of q|k: 3 rounds of 128-wide tiles
    (2048, 512, 64),      # dB of v: 128 tiles of 64 fill the SMs once
    (200, 136, 64),
])
def test_tile_width_pick_on_an_h100(m, n, want):
    """The mainloop's tile width for the training shapes on 132 SMs."""
    assert bwd.pick_tile_n(m, n, 132) == want
