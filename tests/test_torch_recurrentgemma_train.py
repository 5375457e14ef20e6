"""Training recurrentgemma-2b in the port, on the CPU against the JAX
reference: ``lm_loss`` and every leaf's grad in both modes at the smoke
config (3 layers: the ``blocks_{i}`` stacks of ('rg', 'rg', 'local')) and at
4 layers (the pattern does not divide 4: the ``layer_{i:03d}`` subtrees of
the published 26-layer layout); the local block on rung 2 of the QKV ladder
at the published head_dim 256; the RG-LRU block's grads (fp32 and
compute-type gate products, the one-level and the two-level scan); a
4-step ``train_loop`` against the reference's trainer; the training
launcher at ``--smoke`` and ``--tiny --layers 4``.

Both sides run the same numpy weights, drawn by the reference's init kinds
(ones, zeros, Λ with sigmoid(Λ) uniform in [0.9, 0.999]) with each matrix
at std fan_in^-1/2 over its input dim (the reference's own init reads a
stack's leading dim as fan_in, std 1 at 3 layers), and the same batches of
the reference's data pipeline. fp32 compute, so the comparisons are of the
algorithm: loss within 1e-5 relative, grads within 1e-4 of each leaf's
largest entry, as ``tests/test_torch_moe_train.py`` holds mixtral.
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
from repro.data import pipeline as jdata
from repro.models import build_model as j_build_model
from repro.models import rglru as jr
from repro.models.lm import lm_param_defs as j_lm_param_defs
from repro.optim import optimizer as jopt
from repro.train import train_loop as j_train_loop

from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.kernels import journal_counts
from repro_torch.kernels.gemm import rope_store_fits
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import rglru as tr
from repro_torch.models.common import nest, tree_map
from repro_torch.models.lm import layer_slots
from repro_torch.optim.optimizer import named_leaves
from repro_torch.train import loss_and_grads, train_loop

ARCH = "recurrentgemma-2b"
MODES = {"kernel": "pallas_interpret", "reference": "reference"}
# 2 x 40 tokens: every sequence runs past the smoke config's 32-token window
B, S = 2, 40
STEPS = 4


def _cfgs(layers, **kw):
    """(JAX, port) smoke configs in fp32 (d_model 64, 4 heads over one kv
    head at head_dim 16, d_ff 128 geglu, vocab 512, window 32) at
    ``layers`` layers, ``kw`` replaced."""
    return tuple(dataclasses.replace(get(ARCH, smoke=True),
                                     compute_dtype="float32",
                                     num_layers=layers, **kw)
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params(layers, **kw):
    """The reference's tree by its init kinds, each matrix at std
    fan_in^-1/2 over its input dim (the tied embedding's d_model, a conv
    filter's taps), from a numpy seed."""
    rng = np.random.default_rng(layers)
    flat = {}
    for path, d in sorted(j_lm_param_defs(_cfgs(layers, **kw)[0]).items()):
        if d.init == "ones":
            flat[path] = np.ones(d.shape, np.float32)
        elif d.init == "zeros":
            flat[path] = np.zeros(d.shape, np.float32)
        elif d.init == "lru_a":
            u = rng.uniform(0.9, 0.999, d.shape)
            flat[path] = np.log(u / (1 - u)).astype(np.float32)
        else:
            leaf = path.rsplit("/", 1)[-1]
            fan_in = (d.shape[-1] if path == "embed" or leaf == "conv_w"
                      else d.shape[-2])
            flat[path] = (rng.standard_normal(d.shape)
                          / np.sqrt(fan_in)).astype(np.float32)
    return nest(flat)


@functools.lru_cache(maxsize=None)
def _np_batch():
    return tdata.batch_at(tdata.DataConfig(
        vocab_size=_cfgs(3)[1].vocab_size, seq_len=S, global_batch=B), 0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


@contextlib.contextmanager
def _jax_fused():
    """Pin the reference's fusion decisions to the fused plans the port's
    kernel mode runs (the QKV chain, with or without the rope store, and
    the geglu MLP), so its interpret-mode GEMM kernels run forward and
    backward; plans are memoised, so the caches are cleared."""
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


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(layers, mode, **kw):
    jcfg, _ = _cfgs(layers, **kw)
    ctx = _jax_fused() if mode != "reference" else contextlib.nullcontext()
    with ctx:
        model = j_build_model(jcfg, mode=mode)
        params = jax.tree.map(jnp.asarray, _np_params(layers, **kw))
        batch = {k: jnp.asarray(v) for k, v in _np_batch().items()}
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
            params, batch)
        return float(loss), {k: np.asarray(v, np.float32)
                             for k, v in _flat(grads).items()}


def _port_loss_grads(layers, mode, **kw):
    _, cfg = _cfgs(layers, **kw)
    model = build_model(cfg, mode=mode, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(
        _np_params(layers, **kw), "cpu", torch.float32))
    batch = {k: torch.from_numpy(v).to(torch.float32 if k == "loss_mask"
                                       else torch.int64)
             for k, v in _np_batch().items()}
    loss, _, grads = loss_and_grads(model, params, batch)
    return float(loss), {p: g.float().numpy() for (p, _), g
                         in zip(named_leaves(params), grads)}


def _assert_grads(got, want):
    (tloss, tgrads), (jloss, jgrads) = got, want
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert sorted(tgrads) == sorted(jgrads)
    for k, w_ in jgrads.items():
        assert np.abs(w_).max() > 0, k
        err = np.abs(tgrads[k] - w_).max()
        assert err <= 1e-4 * np.abs(w_).max(), (k, err)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layers", [3, 4], ids=["stacked", "per_layer"])
def test_lm_loss_and_grads_match_jax(layers, mode):
    """fp32, fp32 masters cast in the forward, remat 'full' on both sides:
    the loss within 1e-5 relative, every leaf's grad (the RG-LRU's Λ, gates
    and conv filter, the 'rg' blocks' standalone ln1, the local block's
    q|k|v and output, the geglu MLP, the tied embedding's two uses summed)
    within 1e-4 of its largest entry, in the ``blocks_{i}`` stacks (3
    layers) and the ``layer_{i:03d}`` subtrees (4). The kernel mode against
    jax.grad through the reference's interpret-mode kernels, the fused
    plans pinned."""
    got = _port_loss_grads(layers, mode)
    _assert_grads(got, _jax_loss_grads(layers, MODES[mode]))
    prefix = "blocks_" if layers == 3 else "layer_"
    assert all(k.startswith((prefix, "embed", "final_norm"))
               for k in got[1])
    assert any(k.endswith("rec/lambda") for k in got[1])


def test_head_dim_256_rung_2_grads_match_jax():
    """The published head_dim 256 at the smoke width (2 query heads over
    one kv head, 4 layers, so one local block): kernel mode's local block
    takes rung 2 (the q|k and v GEMMs on the norm prologue, then the RoPE
    op, the flash backward at head_dim 256), as the reference's ladder
    falls back; loss and every grad against jax.grad through the
    interpret-mode kernels, within the tolerances above."""
    assert not rope_store_fits(256)
    kw = dict(num_heads=2, head_dim=256)
    _assert_grads(_port_loss_grads(4, "kernel", **kw),
                  _jax_loss_grads(4, "pallas_interpret", **kw))


def test_kernel_mode_journals_each_block_kind():
    """One kernel-mode loss and backward at 4 layers under an ``obs``
    capture: per 'rg' layer 2 ``gemm_fused`` (the geglu up and the down)
    and their GEMM backward; per 'local' layer 4 (q|k with the rope
    store at the smoke's head_dim 16, v, up, down), one flash forward and
    one backward (main and dq conversion), each forward again under the
    remat's recompute."""
    from repro_torch import obs
    _, cfg = _cfgs(4)
    kinds = [kind for kind, _, _ in layer_slots(cfg)]
    assert kinds == ["rg", "rg", "local", "rg"]
    model = build_model(cfg, mode="kernel", device="cpu")
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(
        _np_params(4), "cpu", torch.float32))
    batch = {k: torch.from_numpy(v).long() for k, v in _np_batch().items()
             if k != "loss_mask"}
    with obs.capture() as rec:
        loss_and_grads(model, params, batch)
    got = journal_counts(rec)
    rg, local = kinds.count("rg"), kinds.count("local")
    gemms = 2 * rg + 4 * local
    assert got["gemm_fused"] == 2 * gemms          # forward and recompute
    for name in ("gemm_bwd_g", "gemm_bwd_da", "gemm_bwd_db"):
        assert got[name] == gemms
    assert got["flash_attention_fwd"] == 2 * local
    assert got["flash_attention_bwd"] == 2 * local


# ---------------------------------------------------------------------------
# the RG-LRU block alone
# ---------------------------------------------------------------------------

W, L = 64, 40


def _rglru_params(seed=0):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    u = rng.uniform(0.9, 0.999, W)
    return {"proj_x": normal(W, W), "proj_gate": normal(W, W),
            "conv_w": normal(W, 4), "conv_b": normal(W) * 0.1,
            "w_a": normal(W, W), "b_a": normal(W) * 0.1,
            "w_i": normal(W, W), "b_i": normal(W) * 0.1,
            "lambda": np.log(u / (1 - u)).astype(np.float32),
            "proj_out": normal(W, W)}


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("f32_gates", [True, False], ids=["f32", "compute"])
def test_rglru_block_grads_match_jax(f32_gates, chunk):
    """jax.grad of the reference's ``rglru_forward`` (a weighted sum of its
    output) against the port's autograd through the doubling scan (chunk
    0) or the reference's two-level form (chunk 8, which divides L 40), the
    four-tap fp32 convolution and the fp32 gates, or gate products in the
    compute type: every parameter's grad and the input's within 1e-4 of
    its largest entry."""
    jcfg, tcfg = _cfgs(3, rglru_f32_gates=f32_gates, rglru_chunk=chunk)
    p = _rglru_params()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, L, W)).astype(np.float32)
    w = rng.standard_normal((B, L, W)).astype(np.float32)

    def j_loss(p_, x_):
        return jnp.sum(jr.rglru_forward(jcfg, p_, x_) * w)

    jp, jx = jax.grad(j_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (tr.rglru_forward(tcfg, tp, tx) * torch.from_numpy(w)).sum().backward()
    for k, g in [*((k, jp[k]) for k in p), ("x", jx)]:
        got = (tx if k == "x" else tp[k]).grad.numpy()
        g = np.asarray(g)
        assert np.abs(g).max() > 0, k
        assert np.abs(got - g).max() <= 1e-4 * np.abs(g).max(), k


# ---------------------------------------------------------------------------
# train_loop against the reference's trainer, and the launcher
# ---------------------------------------------------------------------------

def _dcfg(pkg):
    return pkg.DataConfig(vocab_size=_cfgs(3)[1].vocab_size, seq_len=S,
                          global_batch=B, noise=0.05)


@functools.lru_cache(maxsize=None)
def _jax_curve():
    jcfg, _ = _cfgs(3)
    model = j_build_model(jcfg, mode="reference")
    # the reference's train_loop draws its weights from model.init: hand it
    # the numpy weights the port gets
    model.init = lambda rng: jax.tree.map(jnp.asarray, _np_params(3))
    opt = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 1, STEPS))
    res = j_train_loop(model, jdata.DataIterator(_dcfg(jdata)), STEPS, opt,
                       log_every=0, log=lambda *a: None)
    return np.asarray(res.losses, np.float64)


@pytest.mark.parametrize("mode", list(MODES))
def test_train_loop_curve_matches_jax(mode):
    """4 steps at the smoke config, fp32, the same weights and batches,
    AdamW on a cosine schedule from 1e-2: the port's losses within 2e-3 of
    the JAX train_loop's, the criterion of the dense and MoE curves, and
    falling."""
    want = _jax_curve()
    _, cfg = _cfgs(3)
    model = build_model(cfg, mode=mode, device="cpu")
    opt = topt.AdamWConfig(schedule=topt.cosine_schedule(1e-2, 1, STEPS))
    res = train_loop(model, tdata.DataIterator(_dcfg(tdata), device="cpu"),
                     STEPS, opt, params=params_from_numpy(
                         _np_params(3), "cpu", torch.float32), log_every=0)
    got = np.asarray(res.losses, np.float64)
    assert np.isfinite(got).all() and len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert got[-1] < got[0]


@pytest.mark.parametrize("argv", [["--smoke"], ["--tiny", "--layers", "4"]],
                         ids=["smoke", "tiny_4_layers"])
def test_launcher_trains_recurrentgemma_on_the_cpu(argv, capsys):
    """``launch/train.py --arch recurrentgemma-2b`` on the CPU for 2 steps
    past the window (``--tiny`` cuts the RG-LRU's width with d_model):
    the reference launcher's ``[train] finished:`` line, then the port's
    tokens/s and memory lines; ``--layers`` cuts the depth."""
    res = launch_train.main(["--arch", ARCH, *argv, "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "40"])
    out = capsys.readouterr().out
    assert "[train] finished: 2 steps" in out
    layers = 4 if "--layers" in argv else 3
    assert f", {layers} layers, 2 x 40 tokens a step on cpu" in out
    assert "[train] peak device memory: not measured (cpu)" in out
    assert np.isfinite(res.losses).all()
