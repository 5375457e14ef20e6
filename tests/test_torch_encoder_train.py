"""Training of the encoder families in the port, on the CPU against the JAX
reference: bert-110m's masked-LM loss (``encoder_loss``) at the width
``tests/test_models.py::test_bert_mlm_smoke`` cuts it to and
whisper-base's decoder loss (``encdec_loss``) at its ``SMOKE_CONFIG``, the
loss and every leaf's grad (``dbeta`` of each layernorm among them) in
both of the port's modes against ``jax.grad`` of the reference's losses:
the port's reference mode against the JAX 'reference' mode, the kernel
mode (the backward kernels' plain versions on the CPU) against the JAX
'pallas_interpret' mode (its interpret-mode ``_gemm_kernel``,
``_da_kernel``/``_db_kernel``, ``_fwd_kernel`` and ``_dq_kernel``/
``_dkv_kernel``) with the fusion plans pinned to the fused ones; bf16
grads held to the fp32 truth; a 4-step ``train_loop`` curve of bert
against the JAX trainer's; ``make_batch`` and ``MadeBatches``; and the
training launcher at both archs.

Both sides get the same weights, made with numpy from a seed at a trained
model's scale (std fan_in^-1/2; norm scales about 1, norm biases about 0),
and the same batches.
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
from repro.models.encdec import encdec_param_defs as j_encdec_param_defs
from repro.models.encoder import encoder_param_defs as j_encoder_param_defs
from repro.optim import optimizer as jopt
from repro.train import train_loop as j_train_loop

from repro_torch import data as tdata
from repro_torch import optim as topt
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import (MadeBatches, build_model, make_batch,
                                params_from_numpy)
from repro_torch.models.common import nest, tree_map
from repro_torch.optim.optimizer import named_leaves
from repro_torch.train import loss_and_grads, train_loop

ARCHS = ("bert-110m", "whisper-base")
MODES = {"kernel": "pallas_interpret", "reference": "reference"}
# bert at tests/test_models.py::test_bert_mlm_smoke's width
BERT_SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                  d_ff=128, vocab_size=256, max_seq_len=64)
B, S_BERT, S_DEC = 2, 32, 16


def _cfgs(arch, dtype="float32"):
    """(JAX, port) configs: bert cut as test_bert_mlm_smoke cuts it,
    whisper's smoke config; compute in ``dtype``."""
    if arch == "bert-110m":
        return tuple(dataclasses.replace(get(arch), compute_dtype=dtype,
                                         **BERT_SMALL)
                     for get in (j_get_config, get_config))
    return tuple(dataclasses.replace(get(arch, smoke=True),
                                     compute_dtype=dtype)
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params(arch):
    """Weights at a trained model's scale: each matrix at std fan_in^-1/2
    over its input dim (the tied embedding's over d_model), the position
    tables at 0.02, norm scales 1 + N(0, 0.1^2) and norm biases N(0, 0.1^2)
    (so beta and dbeta are not trivial)."""
    jcfg, _ = _cfgs(arch)
    defs = (j_encoder_param_defs if arch == "bert-110m"
            else j_encdec_param_defs)(jcfg)
    rng = np.random.default_rng(0)
    flat = {}
    for path, d in sorted(defs.items()):
        if d.init == "ones":
            x = 1 + 0.1 * rng.standard_normal(d.shape)
        elif d.init == "zeros":
            x = 0.1 * rng.standard_normal(d.shape)
        elif path.endswith("pos"):
            x = 0.02 * rng.standard_normal(d.shape)
        else:
            fan_in = d.shape[-1] if path == "embed" else d.shape[-2]
            x = rng.standard_normal(d.shape) / np.sqrt(fan_in)
        flat[path] = x.astype(np.float32)
    return nest(flat)


@functools.lru_cache(maxsize=None)
def _np_batch(arch):
    """bert: test_bert_mlm_smoke's batch (15% of positions masked to id 0,
    the loss on those); whisper: random targets over random encoder
    embeddings, the last 3 positions of each row out of the loss."""
    _, cfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    if arch == "bert-110m":
        targets = rng.integers(0, cfg.vocab_size, (B, S_BERT))
        mask = rng.uniform(size=(B, S_BERT)) < 0.15
        return {"inputs": np.where(mask, 0, targets).astype(np.int32),
                "targets": targets.astype(np.int32),
                "loss_mask": mask.astype(np.float32)}
    mask = np.ones((B, S_DEC), np.float32)
    mask[:, -3:] = 0
    return {"encoder_embeds": rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
            "inputs": rng.integers(0, cfg.vocab_size,
                                   (B, S_DEC)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size,
                                    (B, S_DEC)).astype(np.int32),
            "loss_mask": mask}


@contextlib.contextmanager
def jax_fused():
    """Pin the reference's fusion decisions to the fused plans, as the
    port's kernel mode runs them: the norm in the q|k and v GEMMs'
    prologue ('qkv') and the MLP chain ('mlp')."""
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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(arch, dtype, mode):
    jcfg, _ = _cfgs(arch, dtype)
    ctx = jax_fused() if mode != "reference" else contextlib.nullcontext()
    with ctx:
        model = j_build_model(jcfg, mode=mode)
        params = jax.tree.map(jnp.asarray, _np_params(arch))
        batch = {k: jnp.asarray(v) for k, v in _np_batch(arch).items()}
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
            params, batch)
        return float(loss), {k: np.asarray(v, np.float32)
                             for k, v in _flat(grads).items()}


def _port_batch(arch):
    return {k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32
                                      else torch.float32)
            for k, v in _np_batch(arch).items()}


def _port_loss_grads(arch, dtype, mode):
    _, tcfg = _cfgs(arch, dtype)
    model = build_model(tcfg, mode=mode, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(_np_params(arch), "cpu",
                                        torch.float32))
    loss, _, grads = loss_and_grads(model, params, _port_batch(arch))
    return float(loss), {p: g.float().numpy() for (p, _), g
                         in zip(named_leaves(params), grads)}


# ---------------------------------------------------------------------------
# The losses and their grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_f32(arch, mode):
    """fp32 on both sides, fp32 master weights cast inside the forward:
    the loss within 1e-5 relative, every leaf's grad (the norms' scales and
    biases among them) within 1e-4 of its largest entry."""
    jloss, jgrads = _jax_loss_grads(arch, "float32", MODES[mode])
    tloss, tgrads = _port_loss_grads(arch, "float32", mode)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert sorted(tgrads) == sorted(jgrads)
    assert any(k.endswith("_bias") for k in tgrads)
    for k, want in jgrads.items():
        err = np.abs(tgrads[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_bf16_track_the_f32_truth(arch, mode):
    """bf16 compute: per leaf, the port's grads are no further from the
    fp32 truth (the reference's fp32 grads) than 2x the reference's bf16
    grads in the same mode, + 1e-3 (the criterion of
    tests/test_backward.py). The losses within 1e-2."""
    _, truth = _jax_loss_grads(arch, "float32", "reference")
    jloss, jgrads = _jax_loss_grads(arch, "bfloat16", MODES[mode])
    tloss, tgrads = _port_loss_grads(arch, "bfloat16", mode)
    assert abs(tloss - jloss) < 1e-2
    for k, t in truth.items():
        p_err = np.abs(tgrads[k] - t).max()
        j_err = np.abs(jgrads[k] - t).max()
        assert p_err <= 2.0 * j_err + 1e-3, (k, p_err, j_err)


def test_remat_gives_the_same_grads():
    """Each block recomputed in the backward (remat_policy 'full', the
    default) gives the grads of 'none' bit for bit on the CPU, for both
    families."""
    for arch in ARCHS:
        _, tcfg = _cfgs(arch)
        got = {}
        for policy in ("full", "none"):
            model = build_model(dataclasses.replace(tcfg,
                                                    remat_policy=policy),
                                mode="kernel", device="cpu")
            params = tree_map(lambda t: t.requires_grad_(),
                              params_from_numpy(_np_params(arch), "cpu",
                                                torch.float32))
            got[policy] = loss_and_grads(model, params, _port_batch(arch))[2]
        for a, b in zip(got["full"], got["none"]):
            assert torch.equal(a, b), arch


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gives_the_full_grads(arch, mode):
    """remat_policy 'dots' (the products' outputs kept, the rest of each
    block recomputed) through ``encoder_loss`` and ``encdec_loss``: the
    grads of 'full' bit for bit on the CPU."""
    _, tcfg = _cfgs(arch)
    got = {}
    for policy in ("full", "dots"):
        model = build_model(dataclasses.replace(tcfg, remat_policy=policy),
                            mode=mode, device="cpu")
        params = tree_map(lambda t: t.requires_grad_(),
                          params_from_numpy(_np_params(arch), "cpu",
                                            torch.float32))
        got[policy] = loss_and_grads(model, params, _port_batch(arch))
    assert float(got["dots"][0]) == float(got["full"][0])
    for a, b in zip(got["full"][2], got["dots"][2]):
        assert torch.equal(a, b), arch


# ---------------------------------------------------------------------------
# train_loop
# ---------------------------------------------------------------------------

STEPS = 4


@functools.lru_cache(maxsize=None)
def _jax_curve():
    jcfg, _ = _cfgs("bert-110m")
    model = j_build_model(jcfg, mode="reference")
    model.init = lambda rng: jax.tree.map(jnp.asarray,
                                          _np_params("bert-110m"))
    dcfg = jdata.DataConfig(vocab_size=BERT_SMALL["vocab_size"],
                            seq_len=S_BERT, global_batch=4, noise=0.05)
    opt = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 1, STEPS))
    res = j_train_loop(model, jdata.DataIterator(dcfg), STEPS, opt,
                       log_every=0, log=lambda *a: None)
    return np.asarray(res.losses, np.float64)


@pytest.mark.parametrize("mode", list(MODES))
def test_bert_train_loop_curve_matches_jax(mode):
    """4 steps of bert's smoke config, fp32, the same weights and the LM
    batches the reference's launcher feeds every arch: the port's curve
    within 2e-3 of the JAX train_loop's (reference mode), the criterion of
    tests/test_torch_train.py's first steps."""
    want = _jax_curve()
    _, tcfg = _cfgs("bert-110m")
    model = build_model(tcfg, mode=mode, device="cpu")
    dcfg = tdata.DataConfig(vocab_size=BERT_SMALL["vocab_size"],
                            seq_len=S_BERT, global_batch=4, noise=0.05)
    opt = topt.AdamWConfig(schedule=topt.cosine_schedule(1e-2, 1, STEPS))
    res = train_loop(model, tdata.DataIterator(dcfg, device="cpu"), STEPS,
                     opt, params=params_from_numpy(_np_params("bert-110m"),
                                                   "cpu", torch.float32),
                     log_every=0)
    got = np.asarray(res.losses, np.float64)
    assert np.isfinite(got).all() and len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# make_batch and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("llama-1b",))
def test_make_batch_keys_shapes_and_types(arch):
    """The reference's keys, shapes and types (its make_batch, non-abstract
    path): encoder_embeds only for the enc-dec family, in the compute type;
    tokens in range; the mask all ones. The same generator state gives the
    same batch."""
    cfg = get_config(arch)
    out = make_batch(cfg, 2, 16, generator=torch.Generator().manual_seed(3))
    keys = ["inputs", "loss_mask", "targets"]
    if cfg.family == "encdec":
        keys.insert(0, "encoder_embeds")
        assert out["encoder_embeds"].shape == (2, cfg.encoder_seq,
                                               cfg.d_model)
        assert out["encoder_embeds"].dtype == torch.bfloat16
    assert sorted(out) == keys
    for k in ("inputs", "targets"):
        assert out[k].shape == (2, 16) and out[k].dtype == torch.int64
        assert 0 <= int(out[k].min()) and int(out[k].max()) < cfg.vocab_size
    assert out["loss_mask"].dtype == torch.float32 and bool(
        (out["loss_mask"] == 1).all())
    again = make_batch(cfg, 2, 16, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(out[k], again[k]) for k in out)


def test_made_batches_restart():
    """A restart (load_state_dict of an earlier step) replays the same
    batches; different steps differ."""
    cfg = get_config("whisper-base", smoke=True)
    it = MadeBatches(cfg, 2, 8, seed=1, device="cpu")
    first, second = next(it), next(it)
    assert not torch.equal(first["inputs"], second["inputs"])
    it.load_state_dict({"step": 0})
    assert torch.equal(next(it)["encoder_embeds"], first["encoder_embeds"])
    assert it.state_dict() == {"step": 1}


@pytest.mark.parametrize("argv", [
    ["--arch", "bert-110m", "--tiny", "--seq", "32"],
    ["--arch", "whisper-base", "--tiny", "--seq", "16"]])
def test_launcher_trains_the_encoder_families(argv, capsys):
    res = launch_train.main(argv + ["--device", "cpu", "--steps", "2",
                                    "--batch", "2", "--lr", "1e-2"])
    out = capsys.readouterr().out
    assert "[train] finished: 2 steps" in out
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
