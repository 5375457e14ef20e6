"""The port's checkpointing (``repro_torch.train.checkpoint``) against the
JAX package's: the reference's ``TestCheckpoint`` cases on the port's state,
checkpoints written by either package restored by the other bit for bit,
the snapshot taken before an in-place AdamW step, and a run resumed by the
port from the JAX trainer's checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.data import pipeline as jdata
from repro.models import build_model as j_build_model
from repro.models.lm import lm_param_defs as j_lm_param_defs
from repro.optim import optimizer as jopt
from repro.train import checkpoint as j_ckpt
from repro.train import init_state as j_init_state
from repro.train import train_loop as j_train_loop

from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import nest
from repro_torch.optim.optimizer import named_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import init_state, train_loop

SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)


def _model(grad_compress=False, seed=0):
    model = build_model(dataclasses.replace(get_config("llama-1b"), **SMALL),
                        mode="reference", device="cpu")
    return model, init_state(model, seed=seed, grad_compress=grad_compress)


def _host(state) -> dict:
    """{path: numpy array or int}: an independent copy of the state."""
    return {k: (v.detach().clone().numpy() if torch.is_tensor(v) else v)
            for k, v in named_leaves(state)}


def _assert_state_equal(got, want: dict):
    flat = dict(named_leaves(got))
    assert sorted(flat) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            g = flat[k].detach().numpy()
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert flat[k] == w and isinstance(flat[k], int), k


def _step_state(state):
    """Make every leaf non-trivial: one in-place AdamW step on seeded
    grads."""
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen)
             for _, p in named_leaves(state["params"])]
    topt.adamw_update(topt.AdamWConfig(schedule=topt.constant_schedule(1e-2)),
                      grads, state["opt"], state["params"])
    state["step"] += 1
    if "ef" in state:
        for e, g in zip([t for _, t in named_leaves(state["ef"])], grads):
            e.copy_(g * 1e-3)
    return state


# ---------------------------------------------------------------------------
# The reference's TestCheckpoint, on the port's state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_compress", [False, True])
def test_roundtrip_is_bitwise(tmp_path, grad_compress):
    model, state = _model(grad_compress)
    state = _step_state(state)
    want = _host(state)
    ckpt.save(state, str(tmp_path), 5)
    restored, step = ckpt.restore(str(tmp_path), init_state(
        model, seed=3, grad_compress=grad_compress))
    assert step == 5
    _assert_state_equal(restored, want)
    for _, p in named_leaves(restored["params"]):
        assert p.requires_grad and p.dtype == torch.float32
    for _, m in named_leaves(restored["opt"]):
        assert not torch.is_tensor(m) or not m.requires_grad
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert "step" in keys and "opt/count" in keys
    assert "params/blocks/attn/wqk" in keys and "opt/m/embed" in keys
    assert any(k.startswith("ef/") for k in keys) == grad_compress


def test_corruption_detected(tmp_path):
    _, state = _model()
    ckpt.save(state, str(tmp_path), 1)
    ckpt.save(state, str(tmp_path), 2)
    with open(tmp_path / "step_00000002" / "arrays.npz", "r+b") as f:
        f.seek(100)
        f.write(b"garbage")
    assert ckpt.available_steps(str(tmp_path)) == [1]
    assert ckpt.restore(str(tmp_path), state)[1] == 1


def test_keep_n(tmp_path):
    _, state = _model()
    for s in range(6):
        ckpt.save(state, str(tmp_path), s, keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [4, 5]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_async_checkpointer(tmp_path):
    _, state = _model()
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(state, 3)
    ac.wait()
    assert ckpt.available_steps(str(tmp_path)) == [3]
    rec, = ac.records
    assert rec["step"] == 3 and rec["bytes"] > 0
    assert rec["write_s"] >= 0 and rec["snapshot_s"] >= 0


def test_async_error_surfaces_on_wait(tmp_path):
    """A write that fails in the background raises on the next wait(), once;
    no checkpoint is left behind."""
    _, state = _model()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac = ckpt.AsyncCheckpointer(str(blocker / "ckpt"))
    ac.save(state, 1)
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()
    assert ckpt.available_steps(str(blocker / "ckpt")) == []


def test_bfloat16_leaf_is_refused(tmp_path):
    _, state = _model()
    state["params"]["embed"] = state["params"]["embed"].bfloat16()
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(state, str(tmp_path), 1)


def test_shape_mismatch_is_refused(tmp_path):
    _, state = _model()
    ckpt.save(state, str(tmp_path), 1)
    state["params"]["embed"] = state["params"]["embed"][:-1]
    with pytest.raises(ValueError, match="shape mismatch for params/embed"):
        ckpt.restore(str(tmp_path), state)


def test_snapshot_is_taken_before_an_in_place_step(tmp_path, monkeypatch):
    """AdamW updates params, m and v in place: the state a save writes is
    the one at save(), though the write runs only after the next step has
    changed every tensor."""
    release = threading.Event()
    write = ckpt._write

    def held_write(*args, **kwargs):
        assert release.wait(timeout=60)
        return write(*args, **kwargs)

    monkeypatch.setattr(ckpt, "_write", held_write)
    _, state = _model()
    state = _step_state(state)
    want = _host(state)
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(state, state["step"])
    state = _step_state(state)             # in place, before the write
    assert not np.array_equal(state["params"]["embed"].detach().numpy(),
                              want["params/embed"])
    release.set()
    ac.wait()
    restored, step = ckpt.restore(str(tmp_path), state)
    assert step == 1
    _assert_state_equal(restored, want)


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_compress", [False, True])
def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path,
                                                        grad_compress):
    """granite-8b's smoke config: a state the reference's ``init_state``
    made (moments and step made non-zero) saved by
    ``repro.train.checkpoint.save`` restores into the port bit for bit;
    the port's save of it restores through ``repro.train.checkpoint.restore``
    bit for bit, ints as 0-d int32."""
    jmodel = j_build_model(j_get_config("granite-8b", smoke=True),
                           mode="reference")
    jstate = j_init_state(jmodel, jax.random.PRNGKey(0),
                          grad_compress=grad_compress)
    jstate["opt"]["m"] = jax.tree.map(lambda x: x * 0.5 + 1.0,
                                      jstate["opt"]["m"])
    jstate["opt"]["count"] = jnp.asarray(7, jnp.int32)
    jstate["step"] = jnp.asarray(7, jnp.int32)
    want = {k: (int(v) if k in ("step", "opt/count") else np.asarray(v))
            for k, v in j_ckpt._flatten(jstate).items()}
    j_ckpt.save(jstate, str(tmp_path / "jax"), 7)

    model = build_model(get_config("granite-8b", smoke=True),
                        mode="reference", device="cpu")
    template = init_state(model, seed=1, grad_compress=grad_compress)
    restored, step = ckpt.restore(str(tmp_path / "jax"), template)
    assert step == 7
    _assert_state_equal(restored, want)

    ckpt.save(restored, str(tmp_path / "port"), 7)
    tpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                       jstate)
    back, step = j_ckpt.restore(str(tmp_path / "port"), tpl)
    assert step == 7
    flat = j_ckpt._flatten(back)
    assert sorted(flat) == sorted(want)
    for k, w in want.items():
        got = np.asarray(flat[k])
        if isinstance(w, int):
            assert got.dtype == np.int32 and got.shape == () and got == w, k
        else:
            assert got.dtype == w.dtype, k
            np.testing.assert_array_equal(got, w, err_msg=k)


def test_jax_bfloat16_leaf_is_refused(tmp_path):
    """A JAX checkpoint holding a bfloat16 leaf: refused with a clear
    error, not guessed."""
    _, state = _model()
    jstate = jax.tree.map(lambda v: jnp.asarray(v.detach().numpy())
                          if torch.is_tensor(v) else jnp.asarray(v, jnp.int32),
                          state)
    jstate["params"]["embed"] = jstate["params"]["embed"].astype(jnp.bfloat16)
    j_ckpt.save(jstate, str(tmp_path), 1)
    with pytest.raises(TypeError, match="params/embed"):
        ckpt.restore(str(tmp_path), state)


STEPS, B, S = 8, 4, 64


def _np_params():
    """Weights at a trained model's scale, as tests/test_torch_train.py
    draws them."""
    cfg = dataclasses.replace(j_get_config("llama-1b"), **SMALL)
    rng = np.random.default_rng(0)
    flat = {}
    for path, d in sorted(j_lm_param_defs(cfg).items()):
        if d.init == "ones":
            flat[path] = np.ones(d.shape, np.float32)
        elif d.init == "zeros":
            flat[path] = np.zeros(d.shape, np.float32)
        else:
            fan_in = d.shape[-1] if path == "embed" else d.shape[-2]
            flat[path] = (rng.standard_normal(d.shape)
                          / np.sqrt(fan_in)).astype(np.float32)
    return nest(flat)


def test_port_resumes_the_jax_trainers_checkpoint(tmp_path):
    """The JAX train_loop (reference mode) trains 8 steps, a checkpoint
    every 4; its directory cut to step 4 resumes the port's train_loop
    there, and the port's losses of steps 5-8 are within the curve
    criterion of tests/test_torch_train.py (rtol = atol = 2e-3) of the JAX
    run's."""
    np_params = _np_params()
    jmodel = j_build_model(dataclasses.replace(j_get_config("llama-1b"),
                                               **SMALL), mode="reference")
    jmodel.init = lambda rng: jax.tree.map(jnp.asarray, np_params)
    jd = jdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=S,
                          global_batch=B, noise=0.05)
    jres = j_train_loop(jmodel, jdata.DataIterator(jd), STEPS,
                        jopt.AdamWConfig(schedule=jopt.cosine_schedule(
                            1e-2, 2, STEPS)),
                        ckpt_dir=str(tmp_path), ckpt_every=4, log_every=0,
                        log=lambda *a: None)
    assert j_ckpt.available_steps(str(tmp_path)) == [4, 8]
    shutil.rmtree(tmp_path / "step_00000008")

    model = build_model(dataclasses.replace(get_config("llama-1b"), **SMALL),
                        mode="reference", device="cpu")
    td = tdata.DataConfig(vocab_size=SMALL["vocab_size"], seq_len=S,
                          global_batch=B, noise=0.05)
    logs = []
    res = train_loop(model, tdata.DataIterator(td, device="cpu"), STEPS,
                     topt.AdamWConfig(schedule=topt.cosine_schedule(
                         1e-2, 2, STEPS)),
                     params=params_from_numpy(np_params, "cpu",
                                              torch.float32),
                     ckpt_dir=str(tmp_path), ckpt_every=4, log_every=0,
                     log=logs.append)
    # the resume, then the batch shape's policy pin (as the reference logs)
    assert logs[0] == "[trainer] resumed from checkpoint at step 4"
    assert len(logs) == 2 and logs[1].startswith(
        f"[trainer] bucket ({B}, {S}): pinned kernel policies ")
    assert len(res.losses) == 4 and res.state["step"] == STEPS
    np.testing.assert_allclose(res.losses, jres.losses[4:], rtol=2e-3,
                               atol=2e-3)
    assert ckpt.available_steps(str(tmp_path)) == [4, 8]
