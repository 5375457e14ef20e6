"""Training mixtral-8x7b's mixture of experts in the port, on the CPU against
the JAX reference: ``lm_loss`` (the load-balancing term included) and every
leaf's grad at the smoke config in both modes, a 3-step ``train_loop``
against the reference's trainer, the experts taken by one ``unbind`` per
stacked leaf, and the training launcher at the smoke config.

Both sides run the same numpy weights (std fan_in^-1/2 over each matrix's
input dim) and the same batches of the reference's data pipeline. fp32
compute, so the comparisons are of the algorithm: each tolerance is stated
where it is used.
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
from repro.models.lm import lm_param_defs as j_lm_param_defs
from repro.optim import optimizer as jopt
from repro.train import train_loop as j_train_loop

from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, lm, moe, params_from_numpy
from repro_torch.models.common import nest, tree_map
from repro_torch.optim.optimizer import named_leaves
from repro_torch.train import loss_and_grads, train_loop

ARCH = "mixtral-8x7b"
MODES = {"kernel": "pallas_interpret", "reference": "reference"}
# 2 x 64 tokens: every sequence runs past the smoke config's 32-token window
B, S = 2, 64
STEPS = 3


def _cfgs():
    """(JAX, port) smoke configs in fp32: 2 layers, d 64, 4 experts top-2,
    d_ff 128, window 32."""
    return tuple(dataclasses.replace(get(ARCH, smoke=True),
                                     compute_dtype="float32")
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params(seed=0):
    """The reference's tree at a trained model's scale: std fan_in^-1/2
    over each matrix's input dim (the experts' and the router's D, the
    tied embedding's d_model)."""
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


@functools.lru_cache(maxsize=None)
def _np_batch():
    return tdata.batch_at(tdata.DataConfig(
        vocab_size=_cfgs()[1].vocab_size, seq_len=S, global_batch=B), 0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


@contextlib.contextmanager
def _jax_mlp_fused():
    """Pin the reference's 'mlp' fusion decision to the fused plan (its byte
    model decides per shape), so its experts run the interpret-mode gemm
    kernels, forward and backward; plans are memoised, so the caches are
    cleared."""
    orig = autotune.select_fusion

    def pinned(kind, shape, dtype="bfloat16", **kw):
        out = orig(kind, shape, dtype, **kw)
        return dict(out, plan="fused") if kind == "mlp" else out

    autotune.clear_policy_cache()
    autotune.select_fusion = pinned
    try:
        yield
    finally:
        autotune.select_fusion = orig
        autotune.clear_policy_cache()


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(mode):
    jcfg, _ = _cfgs()
    model = j_build_model(jcfg, mode=mode)
    params = jax.tree.map(jnp.asarray, _np_params())
    batch = {k: jnp.asarray(v) for k, v in _np_batch().items()}
    ctx = _jax_mlp_fused() if mode != "reference" else contextlib.nullcontext()
    with ctx:
        (loss, metrics), grads = jax.value_and_grad(model.loss, has_aux=True)(
            params, batch)
    return (float(loss), float(metrics["aux"]),
            {k: np.asarray(v, np.float32) for k, v in _flat(grads).items()})


def _port_loss_grads(mode):
    _, cfg = _cfgs()
    model = build_model(cfg, mode=mode, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(_np_params(), "cpu", torch.float32))
    batch = {k: torch.from_numpy(v).to(torch.float32 if k == "loss_mask"
                                       else torch.int64)
             for k, v in _np_batch().items()}
    loss, metrics, grads = loss_and_grads(model, params, batch)
    return (float(loss), float(metrics["aux"]),
            {p: g.float().numpy() for (p, _), g
             in zip(named_leaves(params), grads)})


@pytest.mark.parametrize("mode", list(MODES))
def test_lm_loss_and_grads_match_jax(mode):
    """fp32, fp32 masters cast in the forward, remat 'full' on both sides:
    the loss within 1e-5 relative and its load-balancing term within 1e-6,
    every leaf's grad (the router's, through the softmax and the aux term,
    and each stacked expert leaf's) within 1e-4 of its largest entry. The
    kernel mode against jax.grad through the reference's interpret-mode
    gemm kernels, its expert chains pinned fused."""
    jloss, jaux, jgrads = _jax_loss_grads(MODES[mode])
    tloss, taux, tgrads = _port_loss_grads(mode)
    assert jaux > 0.5        # the term is there: E * sum(f_e p_e), ~1
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=0, atol=1e-6)
    assert sorted(tgrads) == sorted(jgrads)
    assert any(k.startswith("blocks/moe/") for k in tgrads)
    for k, want in jgrads.items():
        assert np.abs(want).max() > 0, k
        err = np.abs(tgrads[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("mode", list(MODES))
def test_aux_weight_reaches_the_router_grad(mode):
    """The load-balancing term's share of the router's grad: lm_loss with
    aux_weight 0.01 less lm_loss with 0 equals 0.01 x the grad of the aux
    alone (within 1e-6 of the router grad's largest entry), and is not
    zero."""
    _, cfg = _cfgs()
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(_np_params(), "cpu", torch.float32))
    batch = {k: torch.from_numpy(v).long() for k, v in _np_batch().items()
             if k != "loss_mask"}
    router = params["blocks"]["moe"]["router"]

    def grad(weight):
        loss, m = lm.lm_loss(cfg, params, batch, mode=mode,
                             aux_weight=weight)
        return torch.autograd.grad(loss, router)[0], m["aux"]

    g1, aux = grad(0.01)
    g0, _ = grad(0.0)
    (g_aux,) = torch.autograd.grad(
        lm.lm_loss(cfg, params, batch, mode=mode)[1]["aux"], router)
    assert float(aux) > 0.5 and g_aux.abs().max() > 0
    np.testing.assert_allclose((g1 - g0).numpy(), (0.01 * g_aux).numpy(),
                               rtol=0, atol=1e-6 * float(g1.abs().max()))


def _grad_parents(root, leaf):
    """The autograd nodes whose inputs include ``leaf``'s grad accumulator,
    in the graph below ``root``."""
    seen, stack, parents = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and getattr(nxt, "variable", None) is leaf:
                parents.append(node)
            stack.append(nxt)
    return parents


def _graph_names(root):
    seen, stack = set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions)
    return [type(n).__name__ for n in seen]


@pytest.mark.parametrize("mode", list(MODES))
def test_experts_are_taken_by_one_unbind_per_leaf(mode):
    """The grad of each stacked expert leaf (E, ., .) reaches it through one
    ``UnbindBackward0`` (its backward stacks the experts' grads once), and
    the graph holds no ``SelectBackward0``: indexing each expert would add
    a zero-filled full-size buffer per expert in the backward. In the
    model, the (L, E, ., .) leaves' grads come through the layers' unbind
    alone, whose inputs are the layers' experts' unbinds alone."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(3)
    p = {k.split("/")[-1]: torch.from_numpy(v[0].copy()).requires_grad_()
         for k, v in _flat(_np_params()).items()
         if k.startswith("blocks/moe/")}
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model))
                         .astype(np.float32))
    out, aux = moe.moe_dense(cfg, p, x, mode=mode)
    root = (out.sum() + aux).grad_fn
    for name in ("w_gate", "w_in", "w_out"):
        parents = _grad_parents(root, p[name])
        assert [type(n).__name__ for n in parents] == ["UnbindBackward0"], \
            (name, parents)
    assert "SelectBackward0" not in _graph_names(root)

    model = build_model(cfg, mode=mode, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(_np_params(), "cpu", torch.float32))
    batch = {k: torch.from_numpy(v).long() for k, v in _np_batch().items()
             if k != "loss_mask"}
    loss, _ = model.loss(params, batch)
    # the layers' unbind of the (cast) leaf, then each layer's experts'
    leaf = params["blocks"]["moe"]["w_in"]
    (layers,) = _grad_parents(loss.grad_fn, leaf)
    if type(layers).__name__ == "ToCopyBackward0":
        (layers,) = _walk_up(loss.grad_fn, layers)
    assert type(layers).__name__ == "UnbindBackward0"
    experts = list(_walk_up(loss.grad_fn, layers))
    assert [type(n).__name__ for n in experts] == \
        ["UnbindBackward0"] * cfg.num_layers


def _walk_up(root, target):
    """The nodes below ``root`` with ``target`` among their inputs."""
    seen, stack = set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is target:
                yield node
            stack.append(nxt)


def test_expert_launches_and_chains_are_unchanged(monkeypatch):
    """Kernel mode still makes 2E forward GEMMs a layer, per expert the
    dual-output silu-gated up projection with no prologue, then the down
    projection with no epilogue, on the expert's contiguous weights."""
    _, cfg = _cfgs()
    calls = []
    ref = gemm_ops.forward_ref

    def recording(a, b, epilogue, prologue, **kw):
        calls.append((epilogue.describe(), prologue.describe(),
                      kw["b2"] is not None, b.is_contiguous()))
        return ref(a, b, epilogue, prologue, **kw)

    monkeypatch.setattr(gemm_ops, "forward_ref", recording)
    p = {k.split("/")[-1]: torch.from_numpy(v[0].copy())
         for k, v in _flat(_np_params()).items()
         if k.startswith("blocks/moe/")}
    x = torch.zeros((1, 4, cfg.d_model))
    with torch.no_grad():
        moe.moe_dense(cfg, p, x, mode="kernel")
    e = cfg.moe.num_experts
    assert calls == [("silu*gate", "none", True, True),
                     ("none", "none", False, True)] * e


# ---------------------------------------------------------------------------
# train_loop against the reference's trainer
# ---------------------------------------------------------------------------

def _dcfg(pkg):
    return pkg.DataConfig(vocab_size=_cfgs()[1].vocab_size, seq_len=S,
                          global_batch=B, noise=0.05)


@functools.lru_cache(maxsize=None)
def _jax_curve():
    jcfg, _ = _cfgs()
    model = j_build_model(jcfg, mode="reference")
    # the reference's train_loop draws its weights from model.init: hand it
    # the numpy weights the port gets
    model.init = lambda rng: jax.tree.map(jnp.asarray, _np_params())
    opt = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 1, STEPS))
    res = j_train_loop(model, jdata.DataIterator(_dcfg(jdata)), STEPS, opt,
                       log_every=0, log=lambda *a: None)
    return np.asarray(res.losses, np.float64)


@pytest.mark.parametrize("mode", list(MODES))
def test_train_loop_curve_matches_jax(mode):
    """3 steps, fp32, the same weights and batches, AdamW on a cosine
    schedule from 1e-2: the port's losses (aux included) within 2e-3 of
    the JAX train_loop's, the criterion of the dense curve
    (tests/test_torch_train.py), and falling."""
    want = _jax_curve()
    _, cfg = _cfgs()
    model = build_model(cfg, mode=mode, device="cpu")
    opt = topt.AdamWConfig(schedule=topt.cosine_schedule(1e-2, 1, STEPS))
    res = train_loop(model, tdata.DataIterator(_dcfg(tdata), device="cpu"),
                     STEPS, opt, params=params_from_numpy(
                         _np_params(), "cpu", torch.float32), log_every=0)
    got = np.asarray(res.losses, np.float64)
    assert np.isfinite(got).all() and len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert got[-1] < got[0]


@pytest.mark.parametrize("argv", [["--smoke"], ["--tiny", "--layers", "1"]],
                         ids=["smoke", "tiny_1_layer"])
def test_launcher_trains_mixtral_on_the_cpu(argv, capsys):
    """``launch/train.py --arch mixtral-8x7b`` on the CPU for 2 steps: the
    reference launcher's ``[train] finished:`` line, then the port's
    tokens/s and memory lines; ``--layers`` cuts the depth."""
    launch_train.main(["--arch", ARCH, *argv, "--device", "cpu", "--steps",
                       "2", "--batch", "2", "--seq", "48"])
    out = capsys.readouterr().out
    assert "[train] finished: 2 steps" in out
    layers = 1 if "--layers" in argv else 2
    assert f", {layers} layers, 2 x 48 tokens a step on cpu" in out
    assert "[train] peak device memory: not measured (cpu)" in out
