"""The policy layer's paths through the models, engines and trainer, held
to the reference's on the CPU.

* ``policies_for_model`` gives the reference's op keys (and fusion
  decisions as its own byte models make them) for every config of both
  registries;
* both engines' ``bucket_policies`` keys equal the reference engines'
  after the same requests, the decode buckets' split policies the ones
  the launches then resolve;
* ``train_loop`` pins once per batch shape: ``trainer.bucket_pins``
  counters equal the reference trainer's over 3 steps of two shapes;
* the same table (the reference's shipped ``cpu.json``, installed with
  arch "cpu") pins the same fusion decisions in both packages;
* ``qkv_plan="auto"`` and the MoE experts under "auto" follow a pinned
  table's decisions (the norm standalone, the experts plain), with
  logits within the existing fp32 tolerance of the JAX package's, also
  where the LM functions are called without the ``Model`` (the decode
  step's MLP included);
* a ``pretuned=`` table that is rejected raises in both engines and in
  ``train_loop``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
from repro import obs as jobs
from repro.configs import get_config as j_get_config
from repro.core import autotune as jat
from repro.data import pipeline as jdata
from repro.models import build_model as j_build_model
from repro.optim import AdamWConfig as JAdamW
from repro.optim import constant_schedule as j_constant
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.train.trainer import train_loop as j_train_loop

from repro_torch import obs
from repro_torch.configs import _MODULES, get_config
from repro_torch.core import autotune as at
from repro_torch.data import pipeline as tdata
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, constant_schedule
from repro_torch.serve import Engine, PagedEngine, Request
from repro_torch.train import train_loop

SMALL = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=256)
REF_CPU_TABLE = os.path.join(os.path.dirname(jat.__file__), "..", "configs",
                             "pretuned", "cpu.json")


@pytest.fixture(autouse=True)
def _fresh_tables():
    for mod in (at, jat):
        mod.clear_pretuned()
        mod.clear_policy_cache()
    yield
    for mod in (at, jat):
        mod.clear_pretuned()
        mod.clear_policy_cache()


def _cfgs(arch="llama-1b", smoke=False, **extra):
    """(JAX, port) configs in fp32: llama-1b cut to SMALL, or an arch."""
    over = dict(SMALL, **extra) if arch == "llama-1b" else extra
    return tuple(dataclasses.replace(get(arch, smoke=smoke),
                                     compute_dtype="float32", **over)
                 for get in (j_get_config, get_config))


@pytest.fixture(scope="module")
def small():
    """The small llama's JAX model, params, and the port model over them."""
    jcfg, cfg = _cfgs()
    jmodel = j_build_model(jcfg, mode="reference")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return (jmodel, jparams, build_model(cfg, mode="kernel", device="cpu"),
            params_from_numpy(np_params, "cpu", torch.float32), np_params)


@pytest.mark.parametrize("smoke", [False, True])
def test_policies_for_model_keys_equal_reference(smoke):
    """Every config of both registries: the reference's op keys; the
    attention layouts of the head_dims the kernels compile are legal."""
    for arch in sorted(_MODULES):
        jcfg, cfg = (get(arch, smoke=smoke) for get in (j_get_config,
                                                        get_config))
        for batch, seq in ((2, 128), (1, 512)):
            got = at.policies_for_model(cfg, batch=batch, seq_len=seq)
            want = jat.policies_for_model(jcfg, batch=batch, seq_len=seq)
            assert sorted(got) == sorted(want), arch
            assert all(p.is_legal() for p in got.values())
            assert set(at.describe_policies(got)) == set(got)


def _requests(cls, v):
    rng = np.random.default_rng(6)
    return [cls(u, rng.integers(0, v, n).astype(np.int32), 3)
            for u, n in enumerate((5, 11, 9, 3))]


def test_engine_bucket_policies_keys_equal_reference(small):
    jmodel, jparams, model, params, _ = small
    prompts = np.random.default_rng(3).integers(0, SMALL["vocab_size"],
                                                (2, 7))
    jeng = JEngine(jmodel, jparams, max_len=16)
    teng = Engine(model, params, max_len=16)
    jeng.generate(prompts, 3)
    with obs.capture() as cap:
        teng.generate(prompts, 3)
    assert sorted(map(str, teng.bucket_policies)) \
        == sorted(map(str, jeng.bucket_policies))
    assert sorted(teng.bucket_policies[(2, 7)]) \
        == sorted(jeng.bucket_policies[(2, 7)])
    pol = teng.bucket_policies[("decode", 2)]["attention_decode"]
    # the decode launches resolved the policy the bucket pinned
    decoded = [e.policy for e in cap.launches if e.op == "attention_decode"]
    assert decoded and all(d == pol.describe() for d in decoded)

    jp = JPagedEngine(jmodel, jparams, batch_slots=2, page_size=4,
                      max_pages_per_seq=6)
    tp = PagedEngine(model, params, batch_slots=2, page_size=4,
                     max_pages_per_seq=6)
    for eng, cls in ((jp, JRequest), (tp, Request)):
        for r in _requests(cls, SMALL["vocab_size"]):
            eng.submit(r)
        eng.run()
    assert sorted(map(str, tp.bucket_policies)) \
        == sorted(map(str, jp.bucket_policies))
    for key, pols in tp.bucket_policies.items():
        assert sorted(pols) == sorted(jp.bucket_policies[key])


class _TwoShapes:
    """Batches alternating between two sequence lengths (both packages'
    iterators, the same (batch, seq) shapes)."""

    def __init__(self, its):
        self.its, self.step = its, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.step += 1
        return next(self.its[(self.step - 1) % 2])

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = state["step"]


def test_train_loop_pins_each_bucket_once(small):
    jmodel, _, model, _, np_params = small
    shapes = ((2, 8), (1, 16))
    with jobs.capture() as jcap:
        jres = j_train_loop(
            jmodel, _TwoShapes([jdata.DataIterator(jdata.DataConfig(
                vocab_size=SMALL["vocab_size"], seq_len=s, global_batch=b))
                for b, s in shapes]), 3,
            JAdamW(schedule=j_constant(1e-3)), log_every=0,
            log=lambda *a: None)
    logs = []
    with obs.capture() as cap:
        res = train_loop(
            model, _TwoShapes([tdata.DataIterator(tdata.DataConfig(
                vocab_size=SMALL["vocab_size"], seq_len=s, global_batch=b),
                device="cpu") for b, s in shapes]), 3,
            AdamWConfig(schedule=constant_schedule(1e-3)), log_every=0,
            params=params_from_numpy(np_params, "cpu", torch.float32),
            log=logs.append)

    def pins(c):
        return {k: v for k, v in c.counters.items()
                if k.startswith("trainer.bucket_pins")}
    assert pins(cap) == pins(jcap) == {
        "trainer.bucket_pins": 2.0, "trainer.bucket_pins.2x8": 1.0,
        "trainer.bucket_pins.1x16": 1.0}
    assert sorted(res.policies) == sorted(jres.policies) == sorted(shapes)
    for key in shapes:
        assert sorted(res.policies[key]) == sorted(jres.policies[key])
    assert [x.split(":")[0] for x in logs] == [
        f"[trainer] bucket {s}" for s in shapes]


def test_shipped_reference_table_pins_the_same_fusion_decisions():
    """The reference's cpu.json in both packages (arch "cpu"): every fusion
    cell it carries decides the same, pinned; a fusion miss falls to the
    byte models."""
    with open(REF_CPU_TABLE) as fh:
        table = json.load(fh)
    assert at.install_pretuned(table, arch="cpu")
    assert jat.install_pretuned(table, arch="cpu")
    for cell in table["fusion"].values():
        kw = dict(cell["kwargs"])
        if "shard" in kw:
            continue
        got = at.select_fusion(cell["kind"], cell["shape"], "bfloat16", **kw)
        want = jat.select_fusion(cell["kind"], cell["shape"], "bfloat16",
                                 **kw)
        assert got["plan"] == want["plan"] == cell["plan"]["plan"]
        assert got["pretuned"] and want["pretuned"]
    with obs.capture() as cap:
        miss = at.select_fusion("mlp", (512, 256, 1024, 1), "bfloat16")
    assert "pretuned" not in miss
    assert cap.counter("autotune.pretuned_fusion_miss") == 1


def _pin_plans(cells):
    """A table (arch "cpu") pinning the fusion plans of ``cells``: (kind,
    shape, kwargs, plan) with the shape's token count exact."""
    fusion = {}
    for kind, shape, kw, plan in cells:
        args = dict(residual=True, prenorm="none", backward=False,
                    causal=False, softcap=False, sink=False)
        args.update(kw)
        fusion[at.pretuned_fusion_key(kind, shape, "float32", **args)] = {
            "plan": {"plan": plan}}
    return {"schema_version": 1, "arch": "cpu", "cells": {},
            "fusion": fusion}


def test_auto_follows_a_pinned_table_in_both_packages(small):
    """qkv_plan="auto" under a table pinning the prenorm 'qkv_rope' chain
    unfused and the plain one fused: the port runs the standalone norm and
    the rope-store GEMMs (no RoPE op), logits within fp32 tolerance of the
    JAX model's, and the JAX autotuner under the same table decides the
    same; the MLP's prenorm chain pinned unfused too."""
    jmodel, jparams, _, params, _ = small
    _, cfg = _cfgs()
    b, s = 2, 8
    t = b * s
    qkv = (t, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    mlp = (t, cfg.d_model, cfg.d_ff, 1)
    table = _pin_plans([("qkv_rope", qkv, dict(prenorm="rmsnorm"), "unfused"),
                        ("qkv_rope", qkv, {}, "fused"),
                        ("mlp", mlp, dict(prenorm="rmsnorm"), "unfused"),
                        ("mlp", mlp, {}, "fused")])
    for mod in (at, jat):
        assert mod.install_pretuned(table, arch="cpu")
        assert [mod.select_fusion(*c, "float32", **kw)["plan"] for c, kw in
                ((("qkv_rope", qkv), dict(prenorm="rmsnorm")),
                 (("qkv_rope", qkv), {}),
                 (("mlp", mlp), dict(prenorm="rmsnorm")),
                 (("mlp", mlp), {}))] == ["unfused", "fused", "unfused",
                                           "fused"]
    tokens = np.random.default_rng(1).integers(0, SMALL["vocab_size"], (b, s))
    auto = build_model(cfg, mode="kernel", device="cpu", qkv_plan="auto")
    with obs.capture() as cap:
        got = auto.forward(params, torch.from_numpy(tokens))
    # per layer: the standalone norms of the QKV and the MLP; the q|k + rope
    # and v GEMMs, the gated up and the down
    assert cap.counter("model.standalone_norm") == 2 * cfg.num_layers
    assert cap.counter("model.standalone_rope") == 0
    assert cap.count("gemm_fused") == 4 * cfg.num_layers
    want = np.asarray(jmodel.forward(jparams, tokens)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_moe_experts_auto_follow_a_pinned_table():
    """mixtral's smoke config under "auto" with the experts' chain
    ('mlp', residual-free) pinned unfused: no expert GEMM launches, logits
    within the fp32 tolerance of the JAX model's; pinned fused: the 2E
    launches, the same logits."""
    jcfg, cfg = _cfgs("mixtral-8x7b", smoke=True)
    jmodel = j_build_model(jcfg, mode="reference")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                               torch.float32)
    b, s = 2, 8
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s))
    want = np.asarray(jmodel.forward(jparams, tokens)[0])
    experts = (b * s, cfg.d_model, cfg.d_ff, 1)
    e = cfg.moe.num_experts
    for plan, launches in (("unfused", 0), ("fused", 2 * e)):
        at.install_pretuned(_pin_plans([("mlp", experts,
                                         dict(residual=False), plan)]),
                            arch="cpu")
        auto = build_model(cfg, mode="kernel", device="cpu", qkv_plan="auto")
        with obs.capture() as cap:
            got = auto.forward(params, torch.from_numpy(tokens))
        qkv_gemms = 2 * cfg.num_layers
        assert cap.count("gemm_fused") == qkv_gemms + launches * cfg.num_layers
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_auto_reaches_the_ffn_through_the_lm_functions(small):
    """The LM functions called without the ``Model``: ``lm_forward`` with
    qkv_plan="auto" under a table pinning the prefill's prenorm MLP chain
    unfused and the plain one fused runs the MLP's standalone norm, as
    the model does; the decode step's MLP (its rows' chain pinned
    unfused, the norm standalone and the plain chain unfused too) runs no
    GEMM kernel, where the default plan launches the up and the down."""
    _, _, _, params, _ = small
    _, cfg = _cfgs()
    b, s = 2, 8
    mlp = (b * s, cfg.d_model, cfg.d_ff, 1)
    dec = (b, cfg.d_model, cfg.d_ff, 1)
    at.install_pretuned(_pin_plans(
        [("mlp", mlp, dict(prenorm="rmsnorm"), "unfused"),
         ("mlp", mlp, {}, "fused"),
         ("mlp", dec, dict(prenorm="rmsnorm"), "unfused"),
         ("mlp", dec, {}, "unfused")]), arch="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, SMALL["vocab_size"], (b, s)))
    with obs.capture() as fixed:
        want = tlm.lm_forward(cfg, params, tokens, mode="kernel")
    with obs.capture() as auto:
        got = tlm.lm_forward(cfg, params, tokens, mode="kernel",
                             qkv_plan="auto")
    assert auto.counter("model.standalone_norm") \
        == fixed.counter("model.standalone_norm") + cfg.num_layers
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    launches = {}
    for plan in ("rope_fused", "auto"):
        cache = tlm.lm_init_cache(cfg, b, 16, "cpu")
        tlm.lm_prefill(cfg, params, tokens, cache, mode="kernel",
                       qkv_plan=plan)
        with obs.capture() as cap:
            tlm.lm_decode_step(cfg, params, tokens[:, -1:], cache, s,
                               mode="kernel", qkv_plan=plan)
        launches[plan] = cap.count("gemm_fused")
    assert launches == {"rope_fused": 2 * cfg.num_layers, "auto": 0}


def test_a_rejected_table_raises(small):
    """``pretuned=`` names a table to run under: one the autotuner
    rejects (here measured on another arch) raises, with the reference's
    counter, in both engines and in ``train_loop``."""
    _, _, model, params, _ = small
    with open(REF_CPU_TABLE) as fh:
        other = dict(json.load(fh), arch="tpu")
    with obs.capture() as cap:
        with pytest.raises(ValueError, match="rejected"):
            Engine(model, params, max_len=16, pretuned=other)
        with pytest.raises(ValueError, match="rejected"):
            PagedEngine(model, params, batch_slots=2, page_size=4,
                        max_pages_per_seq=6, pretuned=other)
        with pytest.raises(ValueError, match="rejected"):
            train_loop(model, None, 1, AdamWConfig(
                schedule=constant_schedule(1e-3)), pretuned=other)
    assert cap.counter("autotune.pretuned_rejected_arch") == 3
    assert at.active_pretuned() is None
