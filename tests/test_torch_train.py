"""The port's training slice on the CPU against the JAX reference: the data
pipeline (bitwise), the schedules and AdamW, ``lm_loss`` and its per-leaf
grads in both modes (the kernel mode's backward kernels run their plain
versions here; the reference's run in interpret mode), and the loss curve
of ``train_loop``. Weights and batches are made with numpy and handed to
both sides.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.data import pipeline as jdata
from repro.models import build_model as j_build_model
from repro.models.lm import lm_param_defs as j_lm_param_defs
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro.train import train_loop as j_train_loop

from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import nest, tree_map
from repro_torch.optim import compression as tcomp
from repro_torch.optim.optimizer import leaves, named_leaves
from repro_torch.train import (FailureInjector, init_state, loss_and_grads,
                               train_loop)
from repro_torch.train import checkpoint as tckpt

SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)
B, S = 2, 64
MODES = {"kernel": "pallas_interpret", "reference": "reference"}


def _cfgs(dtype="float32", **extra):
    return (dataclasses.replace(j_get_config("llama-1b"), compute_dtype=dtype,
                                **SMALL, **extra),
            dataclasses.replace(get_config("llama-1b"), compute_dtype=dtype,
                                **SMALL, **extra))


@functools.lru_cache(maxsize=None)
def _np_params(seed=0):
    """Weights at a trained-model scale (std = fan_in^-1/2 over each
    matrix's input dim, the tied embedding's over d_model), so bf16 grads
    are not rounding noise; the reference's own init draws the stacked
    weights at std (layers)^-1/2 instead."""
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
    return tdata.batch_at(tdata.DataConfig(vocab_size=SMALL["vocab_size"],
                                           seq_len=S, global_batch=B), 0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(dtype, mode, **cfg_extra):
    jcfg, _ = _cfgs(dtype, **cfg_extra)
    model = j_build_model(jcfg, mode=mode)
    params = jax.tree.map(jnp.asarray, _np_params())
    batch = {k: jnp.asarray(v) for k, v in _np_batch().items()}
    (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
        params, batch)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in _flat(grads).items()}


def _port_loss_grads(dtype, mode, **cfg_extra):
    _, tcfg = _cfgs(dtype, **cfg_extra)
    model = build_model(tcfg, mode=mode, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(_np_params(), "cpu", torch.float32))
    batch = {k: torch.from_numpy(v).to(torch.float32 if k == "loss_mask"
                                       else torch.int64)
             for k, v in _np_batch().items()}
    loss, _, grads = loss_and_grads(model, params, batch)
    return float(loss), {p: g.float().numpy() for (p, _), g
                         in zip(named_leaves(params), grads)}


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

DATA = {
    "small": dict(vocab_size=100, seq_len=32, global_batch=4),
    "llama_vocab": dict(vocab_size=128256, seq_len=128, global_batch=3,
                        seed=3, noise=0.05),
    "short_docs": dict(vocab_size=977, seq_len=64, global_batch=2,
                       mean_doc_len=16, mult=17, add=3),
}


@pytest.mark.parametrize("name", list(DATA))
def test_batch_at_is_bitwise_the_reference(name):
    """The same Philox streams: every key, dtype and value of the
    reference's batches, for several steps."""
    jcfg = jdata.DataConfig(**DATA[name])
    tcfg = tdata.DataConfig(**DATA[name])
    for step in (0, 1, 7, 1000):
        want, got = jdata.batch_at(jcfg, step), tdata.batch_at(tcfg, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    rows = range(1, tcfg.global_batch)
    for k, v in jdata.batch_rows(jcfg, 5, rows).items():
        np.testing.assert_array_equal(tdata.batch_rows(tcfg, 5, rows)[k], v)


def test_data_iterator_yields_tensors_and_restarts():
    cfg = tdata.DataConfig(**DATA["small"])
    it = tdata.DataIterator(cfg, device="cpu")
    next(it)
    saved = it.state_dict()
    b1 = next(it)
    assert b1["inputs"].dtype == torch.int64
    assert b1["loss_mask"].dtype == torch.float32
    for k, v in tdata.batch_at(cfg, 1).items():
        np.testing.assert_array_equal(b1[k].numpy(), v)
    it2 = tdata.DataIterator(cfg, device="cpu")
    it2.load_state_dict(saved)
    assert torch.equal(next(it2)["inputs"], b1["inputs"])


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

SCHEDULES = {
    "cosine": (jopt.cosine_schedule, topt.cosine_schedule, (3e-4, 5, 40)),
    "cosine_min": (jopt.cosine_schedule, topt.cosine_schedule,
                   (1e-2, 0, 10, 0.3)),
    "wsd": (jopt.wsd_schedule, topt.wsd_schedule, (1e-3, 4, 50)),
    "wsd_decay": (jopt.wsd_schedule, topt.wsd_schedule, (1e-3, 2, 20, 0.5,
                                                         0.05)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    """Python floats against the reference's fp32: 1e-6 relative."""
    jfn, tfn, args = SCHEDULES[name]
    js, ts = jfn(*args), tfn(*args)
    for step in range(0, 60):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-12)
    assert topt.constant_schedule(0.5)(7) == float(jopt.constant_schedule(
        0.5)(7))


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5, 2)}}

    def make(scale):
        return tree_map(lambda s: (rng.standard_normal(s) * scale
                                   ).astype(np.float32), shapes)
    return make(1.0), [make(0.3), make(3.0), make(0.01)]


@pytest.mark.parametrize("clip_norm", [1.0, 100.0], ids=["clipped", "free"])
def test_adamw_update_matches_reference(clip_norm):
    """Three updates on the same trees (the second one's grads clipped when
    clip_norm is 1): params, moments, count, grad norm and lr within 1e-6
    relative (fp32, the same formula; in place on the port's side)."""
    params, grads = _opt_trees(5)
    sched = (jopt.cosine_schedule(1e-2, 1, 5), topt.cosine_schedule(1e-2, 1, 5))
    jcfg = jopt.AdamWConfig(schedule=sched[0], clip_norm=clip_norm)
    tcfg = topt.AdamWConfig(schedule=sched[1], clip_norm=clip_norm)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.adamw_init(jp)
    tp = tree_map(torch.from_numpy, params)
    tstate = topt.adamw_init(tp)
    for g in grads:
        jp, jstate, jm = jopt.adamw_update(jcfg, jax.tree.map(jnp.asarray, g),
                                           jstate, jp)
        tp, tstate, tm = topt.adamw_update(
            tcfg, tree_map(torch.from_numpy, g), tstate, tp)
        for jt, tt in ((jp, tp), (jstate["m"], tstate["m"]),
                       (jstate["v"], tstate["v"])):
            for a, b in zip(jax.tree.leaves(jt), leaves(tt)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=1e-7)
        assert tstate["count"] == int(jstate["count"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)


def test_global_norm_and_clip_match_reference():
    _, grads = _opt_trees(6)
    g = grads[1]
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, g)))
    np.testing.assert_allclose(float(topt.global_norm(tree_map(
        torch.from_numpy, g))), want, rtol=1e-6)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = topt.clip_by_global_norm(tree_map(torch.from_numpy, g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jc), leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-8)


# ---------------------------------------------------------------------------
# lm_loss and its grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_lm_loss_and_grads_match_jax_f32(mode):
    """fp32 on both sides, fp32 master weights cast inside the forward:
    the loss within 1e-5 relative, every leaf's grad within 1e-4 of its
    largest entry (the kernel mode against jax.grad through the reference's
    forward and backward kernels in interpret mode)."""
    jloss, jgrads = _jax_loss_grads("float32", MODES[mode])
    tloss, tgrads = _port_loss_grads("float32", mode)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert sorted(tgrads) == sorted(jgrads)
    for k, want in jgrads.items():
        err = np.abs(tgrads[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("mode", list(MODES))
def test_lm_grads_bf16_track_the_f32_truth(mode):
    """bf16 compute: per leaf, the port's grads are no further from the
    fp32 truth (the reference's fp32 grads) than 2x the reference's bf16
    grads in the same mode, + 1e-3 (the criterion of
    tests/test_backward.py). The losses within 1e-2."""
    _, truth = _jax_loss_grads("float32", "reference")
    jloss, jgrads = _jax_loss_grads("bfloat16", MODES[mode])
    tloss, tgrads = _port_loss_grads("bfloat16", mode)
    assert abs(tloss - jloss) < 1e-2
    for k, t in truth.items():
        p_err = np.abs(tgrads[k] - t).max()
        j_err = np.abs(jgrads[k] - t).max()
        assert p_err <= 2.0 * j_err + 1e-3, (k, p_err, j_err)


def test_remat_and_config_switches():
    """remat_policy 'full' (blocks recomputed in the backward) and 'dots'
    (the products' outputs kept) give the grads of 'none' bit for bit on
    the CPU; a nonzero ce_chunk runs (its numbers: the ce_chunk tests)."""
    _, full = _port_loss_grads("float32", "kernel")
    for policy in ("none", "dots"):
        _, other = _port_loss_grads("float32", "kernel", remat_policy=policy)
        for k in full:
            np.testing.assert_array_equal(full[k], other[k], err_msg=policy)
    loss, grads = _port_loss_grads("float32", "kernel", ce_chunk=32)
    assert np.isfinite(loss) and sorted(grads) == sorted(full)


def _assert_grads_close(got, want, rel):
    """Every leaf within ``rel`` of its largest entry."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= rel * np.abs(w).max(), (k, err, np.abs(w).max())


@pytest.mark.parametrize("chunk", [32, 24])
@pytest.mark.parametrize("mode", list(MODES))
def test_ce_chunk_matches_jax(mode, chunk):
    """The chunked cross entropy (24 is halved to 16 to divide S = 64): the
    loss and every leaf's grad within 2e-6 of the largest entry of JAX
    lm_loss with the same ce_chunk (the kernel mode against the
    interpret-mode kernels), and within fp32 summation error (2e-6 of the
    largest entry, the loss 1e-6 relative) of the port's unchunked loss."""
    jloss, jgrads = _jax_loss_grads("float32", MODES[mode], ce_chunk=chunk)
    tloss, tgrads = _port_loss_grads("float32", mode, ce_chunk=chunk)
    assert abs(tloss - jloss) <= 2e-6 * abs(jloss)
    _assert_grads_close(tgrads, jgrads, 2e-6)
    uloss, ugrads = _port_loss_grads("float32", mode)
    np.testing.assert_allclose(tloss, uloss, rtol=1e-6)
    _assert_grads_close(tgrads, ugrads, 2e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_dots_grads_are_the_full_grads(mode):
    """remat_policy 'dots': the grads of 'full' bit for bit (fp32, CPU);
    in reference mode also within 2e-6 of the largest entry of JAX's
    'dots' (checkpoint_dots_with_no_batch_dims)."""
    floss, full = _port_loss_grads("float32", mode)
    dloss, dots = _port_loss_grads("float32", mode, remat_policy="dots")
    assert dloss == floss
    for k in full:
        np.testing.assert_array_equal(dots[k], full[k], err_msg=k)
    if mode == "reference":
        jloss, jgrads = _jax_loss_grads("float32", "reference",
                                        remat_policy="dots")
        assert abs(dloss - jloss) <= 2e-6 * abs(jloss)
        _assert_grads_close(dots, jgrads, 2e-6)


@pytest.mark.parametrize("policy,runs", [("full", 2), ("dots", 1),
                                         ("none", 1)])
def test_forward_gemms_run_once_under_dots(monkeypatch, policy, runs):
    """Kernel mode: the forward GEMM op (repro_torch::gemm_fused, its plain
    version on the CPU) runs 4 times a layer in the forward; 'full'
    recomputes them in the backward, 'dots' keeps their outputs."""
    calls = []
    ref = gemm_ops.forward_ref

    def counting(*args, **kwargs):
        calls.append(1)
        return ref(*args, **kwargs)

    monkeypatch.setattr(gemm_ops, "forward_ref", counting)
    _port_loss_grads("float32", "kernel", remat_policy=policy)
    assert len(calls) == 4 * SMALL["num_layers"] * runs


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((96, 40)).astype(np.float32) * 3.0,
            "blocks": {"w": (rng.standard_normal((3, 40, 24)) * 1e-3
                             ).astype(np.float32),
                       "b": rng.standard_normal((3, 24)).astype(np.float32)
                       * 0.5 + 0.5},
            "tiny": (rng.standard_normal(7) * 1e-6).astype(np.float32)}


def test_ef_compress_matches_reference_bitwise():
    """int8 error feedback on a seeded fp32 tree over 5 successive steps:
    q and the scale of every leaf, the dequantised grads and the residuals
    all equal the reference's bit for bit."""
    je = jcomp.ef_init(_grad_tree(0))
    te = tcomp.ef_init(tree_map(torch.from_numpy, _grad_tree(0)))
    for step in range(5):
        g = _grad_tree(step + 1)
        paths = [p for p, _ in named_leaves(g)]
        for path, x in named_leaves(g):
            qj, sj = jcomp._quant(jnp.asarray(x))
            qt, st = tcomp._quant(torch.from_numpy(x))
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj),
                                          err_msg=path)
            assert qt.dtype == torch.int8 and st.item() == float(sj), path
        jd, je = jcomp.ef_compress(jax.tree.map(jnp.asarray, g), je)
        td, te = tcomp.ef_compress(tree_map(torch.from_numpy, g), te)
        for path, a, b in zip(paths, jax.tree.leaves(jd), td):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=(step, path))
        for path, a, b in zip(paths, jax.tree.leaves(je), leaves(te)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=(step, path))


def test_microbatches_sum_grads_in_f32():
    """microbatches=2 equals microbatches=1 within fp32 tolerance (1e-5 of
    each leaf's largest grad) on a batch without a loss mask, where the
    mean of the two halves' losses is the whole batch's."""
    _, tcfg = _cfgs()
    model = build_model(tcfg, mode="kernel", device="cpu")
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(_np_params(), "cpu", torch.float32))
    batch = {k: torch.from_numpy(v).long() for k, v in _np_batch().items()
             if k != "loss_mask"}
    l1, _, g1 = loss_and_grads(model, params, batch)
    l2, _, g2 = loss_and_grads(model, params, batch, microbatches=2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for a, b in zip(g1, g2):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()


def test_init_state_keeps_fp32_masters():
    """Training state: fp32 masters that require grad and zero moments;
    the serving copy stays in the compute type."""
    _, tcfg = _cfgs("bfloat16")
    model = build_model(tcfg, mode="kernel", device="cpu")
    state = init_state(model, seed=1)
    for p in leaves(state["params"]):
        assert p.dtype == torch.float32 and p.requires_grad
    assert all(not m.any() for m in leaves(state["opt"]["m"]))
    assert state["opt"]["count"] == 0 and state["step"] == 0
    for p in leaves(model.init(seed=1)):
        assert p.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# train_loop
# ---------------------------------------------------------------------------

STEPS = 8


@functools.lru_cache(maxsize=None)
def _jax_curve():
    jcfg, _ = _cfgs()
    model = j_build_model(jcfg, mode="reference")
    # the reference's train_loop draws its weights from model.init: hand it
    # the numpy weights the port gets
    model.init = lambda rng: jax.tree.map(jnp.asarray, _np_params())
    dcfg = jdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=S,
                            global_batch=4, noise=0.05)
    opt = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 2, STEPS))
    res = j_train_loop(model, jdata.DataIterator(dcfg), STEPS, opt,
                       log_every=0, log=lambda *a: None)
    return np.asarray(res.losses, np.float64)


@pytest.mark.parametrize("mode", list(MODES))
def test_train_loop_curve_matches_jax(mode):
    """8 steps, fp32, the same weights and batches: the port's loss curve
    against the JAX train_loop's (reference mode) under the criterion of
    tests/test_backward.py: within 2e-3 over the first 4 steps, 0.2 over
    all (measured: 4.3e-6). The weights are the numpy ones of _np_params:
    at the reference's init, grads of 1e-7 against a largest of 0.1 differ
    in sign between the two frameworks' fp32 sums, and AdamW's first step
    turns each such flip into a 2 x lr difference of a weight."""
    want = _jax_curve()
    _, tcfg = _cfgs()
    model = build_model(tcfg, mode=mode, device="cpu")
    dcfg = tdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=S,
                            global_batch=4, noise=0.05)
    opt = topt.AdamWConfig(schedule=topt.cosine_schedule(1e-2, 2, STEPS))
    res = train_loop(model, tdata.DataIterator(dcfg, device="cpu"), STEPS,
                     opt, params=params_from_numpy(_np_params(), "cpu",
                                                   torch.float32),
                     log_every=0)
    got = np.asarray(res.losses, np.float64)
    assert np.isfinite(got).all() and len(got) == STEPS
    np.testing.assert_allclose(got[:4], want[:4], rtol=2e-3, atol=2e-3)
    assert np.abs(got - want).max() < 0.2, (got.tolist(), want.tolist())
    assert got[-1] < got[0] - 1.0


def test_failure_restarts_from_scratch(tmp_path):
    """Without a checkpoint a simulated failure restarts from step 0 with
    fresh state, and the replayed steps repeat the first run's losses;
    with one, the same failure restores the newest checkpoint and replays
    from there."""
    _, tcfg = _cfgs()
    model = build_model(tcfg, mode="kernel", device="cpu")
    dcfg = tdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=32,
                            global_batch=2)
    opt = topt.AdamWConfig(schedule=topt.constant_schedule(1e-3))
    res = train_loop(model, tdata.DataIterator(dcfg, device="cpu"), 3, opt,
                     failure_injector=FailureInjector((2,)), log_every=0,
                     log=lambda *a: None)
    assert res.restarts == 1
    assert len(res.losses) == 5
    np.testing.assert_array_equal(res.losses[2:4], res.losses[:2])
    logs = []
    res = train_loop(model, tdata.DataIterator(dcfg, device="cpu"), 3, opt,
                     failure_injector=FailureInjector((2,)), log_every=0,
                     ckpt_dir=str(tmp_path), ckpt_every=1, log=logs.append)
    assert res.restarts == 1 and len(res.losses) == 3
    assert "[trainer] restored step 2" in logs
    assert tckpt.available_steps(str(tmp_path)) == [1, 2, 3]


def _small_loop(tmp_path, steps, **kw):
    _, tcfg = _cfgs()
    model = build_model(tcfg, mode="reference", device="cpu")
    dcfg = tdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=32,
                            global_batch=4, noise=0.05)
    opt = topt.AdamWConfig(schedule=topt.cosine_schedule(3e-3, 2, steps))
    return train_loop(model, tdata.DataIterator(dcfg, device="cpu"), steps,
                      opt, ckpt_dir=str(tmp_path), log_every=0,
                      log=lambda *a: None, **kw)


def test_restart_trajectory_matches(tmp_path):
    """The port of the reference's test of the same name: a run that fails
    at step 9 and restores step 8 ends with the losses of an uninterrupted
    run, bit for bit on the CPU (stateless data, checkpointed state)."""
    r1 = _small_loop(tmp_path / "a", 12, ckpt_every=4)
    r2 = _small_loop(tmp_path / "b", 12, ckpt_every=4,
                     failure_injector=FailureInjector((9,)))
    assert r2.restarts == 1 and len(r2.losses) == 13
    assert r2.losses[-4:] == r1.losses[-4:]        # steps 9-12, replayed
    for (k, a), (_, b) in zip(named_leaves(r1.state), named_leaves(r2.state)):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), k


@functools.lru_cache(maxsize=None)
def _jax_compressed_curve():
    jcfg, _ = _cfgs()
    model = j_build_model(jcfg, mode="reference")
    model.init = lambda rng: jax.tree.map(jnp.asarray, _np_params())
    dcfg = jdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=S,
                            global_batch=4, noise=0.05)
    opt = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 2, STEPS))
    res = j_train_loop(model, jdata.DataIterator(dcfg), STEPS, opt,
                       grad_compress=True, log_every=0, log=lambda *a: None)
    return np.asarray(res.losses, np.float64)


def test_grad_compress_curve_matches_jax():
    """train_loop(grad_compress=True), 8 steps in reference mode, against
    the JAX train_loop(grad_compress=True) under the curve criterion of
    test_train_loop_curve_matches_jax; the state holds fp32 residuals."""
    want = _jax_compressed_curve()
    _, tcfg = _cfgs()
    model = build_model(tcfg, mode="reference", device="cpu")
    dcfg = tdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=S,
                            global_batch=4, noise=0.05)
    opt = topt.AdamWConfig(schedule=topt.cosine_schedule(1e-2, 2, STEPS))
    res = train_loop(model, tdata.DataIterator(dcfg, device="cpu"), STEPS,
                     opt, params=params_from_numpy(_np_params(), "cpu",
                                                   torch.float32),
                     grad_compress=True, log_every=0)
    got = np.asarray(res.losses, np.float64)
    assert np.isfinite(got).all() and len(got) == STEPS
    np.testing.assert_allclose(got[:4], want[:4], rtol=2e-3, atol=2e-3)
    assert np.abs(got - want).max() < 0.2, (got.tolist(), want.tolist())
    assert got[-1] < got[0] - 1.0
    ef = leaves(res.state["ef"])
    assert len(ef) == len(leaves(res.state["params"]))
    assert all(e.dtype == torch.float32 and e.abs().max() > 0 for e in ef)


def test_launcher_trains_on_the_cpu(capsys):
    res = launch_train.main(["--tiny", "--device", "cpu", "--steps", "2",
                             "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "[train] finished: 2 steps" in out
    assert "tokens/s" in out and "not measured (cpu)" in out
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()


def test_launcher_checkpoints_and_compresses(tmp_path, capsys):
    """--ckpt-dir, --ckpt-every and --grad-compress: a failure at step 3
    restores step 2, and the last save is step 4."""
    res = launch_train.main(["--tiny", "--device", "cpu", "--steps", "4",
                             "--batch", "2", "--seq", "32", "--mode",
                             "reference", "--grad-compress", "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "2",
                             "--fail-at", "3"])
    out = capsys.readouterr().out
    assert "[trainer] restored step 2" in out
    assert "[train] finished: 5 steps" in out and "restarts 1" in out
    assert "ef" in res.state
    assert tckpt.available_steps(str(tmp_path)) == [2, 4]
