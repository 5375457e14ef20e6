"""internvl2-2b's vision-language family in the port against the JAX
reference on the CPU, at its smoke config (2 layers, d_model 64, 4 heads
over 2 kv heads, swiglu d_ff 128, 8 patches), in fp32: the parameter tree;
``vlm_forward`` (the text positions' logits behind the prepended patch
embeddings) and ``vlm_loss`` in both modes (kernel mode against the
reference's interpret-mode kernels); every leaf's grad against
``jax.grad``; ``make_batch``'s shapes against the reference's; text-only
serving on the LM backbone through ``Engine`` + ``RequestQueue`` and
``PagedEngine`` (its prefix cache and chunked prefill too), the greedy
streams equal to the JAX engines'; the serving and training launchers.
Both sides run the reference's seeded init, converted with
``params_from_numpy``, and the same numpy-seeded patch embeddings and
tokens.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig
from repro.models import build_model as j_build_model
from repro.models import make_batch as j_make_batch
from repro.models.vlm import vlm_param_defs as j_vlm_param_defs
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, make_batch, params_from_numpy
from repro_torch.models.common import tree_map
from repro_torch.models.vlm import vlm_forward, vlm_param_defs
from repro_torch.optim.optimizer import named_leaves
from repro_torch.serve import Engine, PagedEngine, Request, RequestQueue
from repro_torch.train import loss_and_grads

ARCH = "internvl2-2b"
MODES = {"kernel": "pallas_interpret", "reference": "reference"}
B, S_TEXT, MAX_LEN = 2, 24, 48
# fractions of the logits' max abs (forward) and of each leaf's largest
# grad entry: fp32 sums in another order. At the reference's init (each
# stacked matrix at std 2^-1/2, its fan_in read as the layer count) JAX's
# fp32 grads sit up to 1.3e-4 of a leaf's largest entry from a float64 run
# of the port (the embedding's), the port's fp32 grads up to 7e-5
REL, GRAD_REL = 1e-4, 3e-4


def _cfgs():
    return tuple(dataclasses.replace(get(ARCH, smoke=True),
                                     compute_dtype="float32")
                 for get in (j_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _np_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, j_build_model(
        jcfg, mode="reference").init(jax.random.PRNGKey(0)))


def _port_params():
    return params_from_numpy(_np_params(), "cpu", torch.float32)


@functools.lru_cache(maxsize=None)
def _np_batch():
    """8 patch embeddings, then 24 text tokens and their targets."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (B, S_TEXT + 1)).astype(np.int32)
    return {"patch_embeds": rng.standard_normal((B, 8, 64)).astype(
                np.float32),
            "inputs": toks[:, :-1], "targets": toks[:, 1:],
            "loss_mask": (rng.uniform(size=(B, S_TEXT)) < 0.8).astype(
                np.float32)}


def _port_batch():
    return {k: torch.from_numpy(v).long() if k in ("inputs", "targets")
            else torch.from_numpy(v) for k, v in _np_batch().items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


@functools.lru_cache(maxsize=None)
def _jax_outputs(mode):
    """(the text logits, the loss, {path: grad})."""
    jcfg, _ = _cfgs()
    m = j_build_model(jcfg, mode=mode)
    params = jax.tree.map(jnp.asarray, _np_params())
    batch = {k: jnp.asarray(v) for k, v in _np_batch().items()}
    logits = np.asarray(m.forward(params, batch)[0], np.float32)
    (loss, _), grads = jax.value_and_grad(m.loss, has_aux=True)(params,
                                                                 batch)
    return logits, float(loss), {k: np.asarray(v, np.float32)
                                 for k, v in _flat(grads).items()}


def test_param_tree_is_the_references():
    """The backbone's paths and shapes, at the smoke and published widths
    (the frontend is the stub's: no parameters)."""
    for jcfg, tcfg in (_cfgs(), (j_get_config(ARCH), get_config(ARCH))):
        want = {k: tuple(v.shape) for k, v in j_vlm_param_defs(jcfg).items()}
        assert {k: tuple(v.shape)
                for k, v in vlm_param_defs(tcfg).items()} == want


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_and_loss_match_jax(mode):
    """The text positions' logits (B, 24, V) within REL of their max abs,
    and the masked loss within 1e-5 relative, of the JAX model's in the
    mode's counterpart: kernel mode (the port's kernels' plain versions on
    the CPU) against the reference's interpret-mode kernels."""
    want_logits, want_loss, _ = _jax_outputs(MODES[mode])
    _, tcfg = _cfgs()
    m = build_model(tcfg, mode=mode, device="cpu")
    with torch.no_grad():
        logits = m.forward(_port_params(), _port_batch()).numpy()
        loss, metrics = m.loss(_port_params(), _port_batch())
    assert logits.shape == want_logits.shape == (B, S_TEXT, 512)
    np.testing.assert_allclose(
        logits, want_logits, rtol=0,
        atol=REL * float(np.abs(want_logits).max()))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert float(metrics["aux"]) == 0.0


def test_patches_condition_the_text():
    """Other patch embeddings change the text logits (the blocks attend
    across the whole sequence, causally), and the text's own prefix does
    not see later text: the first text position's logits depend on the
    patches and that token only."""
    _, tcfg = _cfgs()
    params, batch = _port_params(), _port_batch()
    with torch.no_grad():
        base = vlm_forward(tcfg, params, batch)
        other = vlm_forward(tcfg, params, dict(
            batch, patch_embeds=batch["patch_embeds"] + 1.0))
        cut = vlm_forward(tcfg, params, dict(
            batch, inputs=batch["inputs"][:, :1]))
    assert (base - other).abs().max() > 1e-3
    torch.testing.assert_close(cut[:, 0], base[:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
def test_grads_match_jax(mode):
    """``vlm_loss``'s grads (remat 'full', fp32 masters cast in the
    forward) against ``jax.grad`` of the reference's loss: every leaf
    within GRAD_REL of its largest entry, the loss within 1e-5
    relative."""
    _, want_loss, want = _jax_outputs("reference")
    _, tcfg = _cfgs()
    model = build_model(tcfg, mode=mode, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(), _port_params())
    loss, _, grads = loss_and_grads(model, params, _port_batch())
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = {p: g.numpy() for (p, _), g in zip(named_leaves(params), grads)}
    assert sorted(got) == sorted(want)
    for k, w_ in want.items():
        assert np.abs(w_).max() > 0, k
        err = np.abs(got[k] - w_).max()
        assert err <= GRAD_REL * np.abs(w_).max(), (k, err)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
def test_make_batch_shapes_are_the_references(smoke):
    """``make_batch`` at 2 x 40 positions (smoke) or 2 x 2048 (published):
    patch embeddings (B, P, d_model) in the compute type and P fewer text
    positions, as the reference's ``make_batch``."""
    jcfg, tcfg = j_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                              smoke=smoke)
    seq = 40 if smoke else 2048
    want = j_make_batch(jcfg, ShapeConfig("t", seq, 2, "train"),
                        abstract=True)
    got = make_batch(tcfg, 2, seq, generator=torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
    assert got["patch_embeds"].dtype == torch.bfloat16
    assert got["inputs"].shape == (2, seq - tcfg.num_patches)


def test_a_non_uniform_backbone_is_refused():
    """The vlm backbone is a uniform stack, as the reference asserts."""
    _, tcfg = _cfgs()
    cfg = dataclasses.replace(tcfg, num_layers=3,
                              block_pattern=("attn", "local"))
    with pytest.raises(ValueError, match="uniform stack"):
        vlm_forward(cfg, {}, _port_batch())


# ---------------------------------------------------------------------------
# text-only serving on the backbone, fp32
# ---------------------------------------------------------------------------

PAGED_KW = {
    "paged": dict(batch_slots=2, page_size=8, max_pages_per_seq=6),
    "fast": dict(batch_slots=2, page_size=8, max_pages_per_seq=6,
                 prefix_cache=True, chunk_tokens=8),
}


def _requests(cls, kind):
    rng = np.random.default_rng(1)
    lens = [20, 13, 24, 17, 22] if kind == "fixed" else [5, 13, 37, 21]
    return [cls(uid, rng.integers(0, 512, n).astype(np.int32), 6)
            for uid, n in enumerate(lens)]


@functools.lru_cache(maxsize=None)
def _jax_streams(engine):
    jcfg, _ = _cfgs()
    model = j_build_model(jcfg, mode="reference")
    params = jax.tree.map(jnp.asarray, _np_params())
    if engine == "fixed":
        q = JRequestQueue(JEngine(model, params, max_len=MAX_LEN), 2,
                          buckets=(24,))
        for r in _requests(JRequest, "fixed"):
            q.submit(r)
        q.flush(force=True)
        return q.results
    eng = JPagedEngine(model, params, **PAGED_KW[engine])
    for r in _requests(JRequest, engine):
        eng.submit(r)
    return eng.run()


@pytest.mark.parametrize("engine", ["fixed", "paged", "fast"])
@pytest.mark.parametrize("mode", list(MODES))
def test_text_only_streams_equal_jax_f32(mode, engine):
    """Text-only serving on the backbone, as the reference's: Engine +
    RequestQueue (13-24-token prompts left-padded to 24, a forced partial
    batch) and PagedEngine (prompts ending mid-page; with its prefix cache
    and 8-token chunks, the fast paths of an attention-only stack) give
    the JAX engines' greedy streams."""
    _, tcfg = _cfgs()
    model = build_model(tcfg, mode=mode, device="cpu")
    params = _port_params()
    if engine == "fixed":
        q = RequestQueue(Engine(model, params, max_len=MAX_LEN), 2,
                         buckets=(24,))
        for r in _requests(Request, "fixed"):
            q.submit(r)
        q.flush(force=True)
        got = q.results
    else:
        eng = PagedEngine(model, params, **PAGED_KW[engine])
        for r in _requests(Request, engine):
            eng.submit(r)
        got = eng.run()
    want = _jax_streams(engine)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


def test_prefill_takes_a_batch_dict_as_the_reference():
    """``Model.prefill`` of a dict prefills its "inputs" on the backbone
    (the patches are not served), as the reference's vlm prefill does."""
    _, tcfg = _cfgs()
    m = build_model(tcfg, mode="reference", device="cpu")
    params, batch = _port_params(), _port_batch()
    with torch.no_grad():
        _, a = m.prefill(params, batch, m.init_cache(B, MAX_LEN))
        _, b = m.prefill(params, batch["inputs"], m.init_cache(B, MAX_LEN))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serving_launcher_on_the_cpu(capsys):
    """launch/serve.py serves the smoke config's backbone on the CPU
    through the request queue."""
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--prompt-len", "16", "--new-tokens", "4"])
    assert "served 3 requests (3 unique results)" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--smoke"], ["--tiny"]])
def test_training_launcher_on_the_cpu(argv, capsys):
    """launch/train.py --arch internvl2-2b trains 2 steps on make_batch
    batches (8 patches and 32 text tokens) on the CPU."""
    res = launch_train.main(["--arch", ARCH, *argv, "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "40"])
    out = capsys.readouterr().out
    assert "[train] finished: 2 steps" in out
    assert ", 2 layers, 2 x 40 tokens a step on cpu" in out
    assert np.isfinite(res.losses).all()
