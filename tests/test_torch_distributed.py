"""The port's distributed layer over torch.distributed, on the CPU: one gloo
world of 4 processes, spawned once for the module (a ``file://`` store
under the module's temporary directory), against the JAX package on 4
forced host devices (one ``subproc`` call for every reference number).

Covered: ``moe_ep``/``moe_tp`` against the JAX ``moe_ep``/``moe_tp`` on a
(2, 2) ('data', 'model') mesh at capacity factors 4.0 (no drops; also
against ``moe_dense``) and 1.0 (drops), in both modes; the ring collective
GEMM against its gather plan and the oracle, bit for bit, both variants,
and the JAX oracle; ``compressed_psum``; the data-parallel ZeRO-1 trainer
(3 steps on a (4, 1) mesh against the JAX unsharded step on the global
batch; ZeRO-1 on and off bit for bit, with and without ``grad_compress``);
a sharded checkpoint restored under another mesh; ``DataIterator``'s rows;
both engines serving a model built over the mesh. Inputs are made with
numpy from a seed and handed to both sides.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config

WORLD = 4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MOE = dict(name="t", family="lm", num_layers=1, d_model=64, num_heads=4,
           num_kv_heads=2, d_ff=128, vocab_size=64, block_pattern=("moe",))
MB, MS = 4, 64                      # the MoE tokens: (B, S, d_model)
GM, GK, GN = 64, 128, 96            # the collective GEMM
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)
TB, TS, STEPS = 4, 64, 3            # the trainer's global batch
CASES = [(impl, cf) for impl in ("ep", "tp") for cf in (4.0, 1.0)]


def _np_inputs(path):
    rng = np.random.default_rng(7)
    e, d, f = 8, MOE["d_model"], MOE["d_ff"]
    arrays = {
        "x": rng.standard_normal((MB, MS, d)).astype(np.float32),
        "router": rng.standard_normal((d, e)).astype(np.float32),
        "w_in": (rng.standard_normal((e, d, f)) / np.sqrt(d)
                 ).astype(np.float32),
        "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)
                   ).astype(np.float32),
        "w_out": (rng.standard_normal((e, f, d)) / np.sqrt(f)
                  ).astype(np.float32),
        "norm": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        "gx": rng.standard_normal((GM, GK)).astype(np.float32),
        "gw": rng.standard_normal((GK, GN)).astype(np.float32),
        # dyadic: every sum exact, so any summation order gives these bits
        "dx": rng.integers(-8, 9, (GM, GK)).astype(np.float32) / 4,
        "dw": rng.integers(-8, 9, (GK, GN)).astype(np.float32) / 4,
        "px": np.linspace(-1, 1, 512).astype(np.float32),
        "prank": rng.standard_normal((WORLD, 512)).astype(np.float32),
    }
    from repro.configs import get_config as j_get_config
    from repro.models.lm import lm_param_defs
    jcfg = dataclasses.replace(j_get_config("llama-1b"), compute_dtype=
                               "float32", **SMALL)
    for key, d_ in sorted(lm_param_defs(jcfg).items()):
        if d_.init == "ones":
            w = np.ones(d_.shape, np.float32)
        elif d_.init == "zeros":
            w = np.zeros(d_.shape, np.float32)
        else:
            fan_in = d_.shape[-1] if key == "embed" else d_.shape[-2]
            w = (rng.standard_normal(d_.shape) / np.sqrt(fan_in)
                 ).astype(np.float32)
        arrays["param/" + key] = w
    np.savez(path, **arrays)


JAX = r'''
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ModelConfig, MoEConfig
from repro.models import build_model
from repro.models.common import nest
from repro.models.moe import moe_forward, moe_dense
from repro.kernels.gemm import gemm_collective_oracle
from repro.optim import compressed_psum
from repro.optim import optimizer as jopt
from repro.data import pipeline as jdata
from repro.train import train_loop
a = dict(np.load("{DIR}/inputs.npz"))
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"))
x = jnp.asarray(a["x"])
for impl, cf in {CASES}:
    cfg = ModelConfig(**{MOE}, moe=MoEConfig(num_experts=8, top_k=2,
        capacity_factor=cf, impl=impl,
        shard="expert" if impl == "ep" else "ffn"))
    p = {k: jnp.asarray(a[k]) for k in ("router", "w_in", "w_gate", "w_out")}
    o, aux = moe_forward(cfg, p, x, mesh=mesh, mode="reference",
                         prenorm=(jnp.asarray(a["norm"]), None))
    out[f"moe/{impl}/{cf}/out"] = np.asarray(o)
    out[f"moe/{impl}/{cf}/aux"] = np.asarray(aux)
for v in ("all_gather", "reduce_scatter"):
    for k in ("g", "d"):
        out[f"oracle/{v}/{k}"] = np.asarray(gemm_collective_oracle(
            jnp.asarray(a[k + "x"]), jnp.asarray(a[k + "w"]), variant=v,
            axis_size=4))
out["psum"] = np.asarray(compressed_psum(jnp.asarray(a["px"]), mesh, "data"))
jcfg = dataclasses.replace(get_config("llama-1b"), compute_dtype="float32",
                           **{SMALL})
params = nest({k[6:]: jnp.asarray(v) for k, v in a.items()
               if k.startswith("param/")})
for gc in (False, True):
    model = build_model(jcfg, mode="reference")
    # a copy per run: the trainer donates its state
    model.init = lambda rng: jax.tree.map(jnp.array, params)
    dcfg = jdata.DataConfig(vocab_size={V}, seq_len={TS}, global_batch={TB})
    opt = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 2, {STEPS}))
    res = train_loop(model, jdata.DataIterator(dcfg), {STEPS}, opt,
                     grad_compress=gc, log_every=0, log=lambda *a: None)
    out[f"curve/{gc}"] = np.asarray(res.losses, np.float64)
np.savez("{DIR}/jax.npz", **out)
print("OK")
'''


WORKER = r'''
import dataclasses, os, sys, tempfile
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.data import DataConfig, DataIterator
from repro_torch.distributed.sharding import gather_tree, mesh_coords
from repro_torch.kernels.gemm.collective import (gemm_collective_oracle,
                                                 gemm_collective_sharded)
from repro_torch.models import build_model, moe, params_from_numpy
from repro_torch.models.common import nest
from repro_torch.optim import (AdamWConfig, compressed_psum,
                               cosine_schedule)
from repro_torch.optim.optimizer import named_leaves
from repro_torch.serve.engine import Engine, PagedEngine, Request
from repro_torch.train import train_loop
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import sharded_init, state_shardings
a = dict(np.load(f"{d}/inputs.npz"))
T = torch.from_numpy
res = {}
m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
c = mesh_coords(m22)
res["coords"] = (c["data"], c["model"])

# MoE: this rank's rows of x, its experts (ep) or F slice (tp)
xl = T(a["x"])[c["data"] * 2:(c["data"] + 1) * 2]
for impl, cf in {CASES}:
    cfg = ModelConfig(**{MOE}, moe=MoEConfig(num_experts=8, top_k=2,
        capacity_factor=cf, impl=impl,
        shard="expert" if impl == "ep" else "ffn"))
    full = {k: T(a[k]) for k in ("router", "w_in", "w_gate", "w_out")}
    p = moe.local_experts(cfg, full, m22)
    for mode in ("reference", "kernel"):
        o, aux = moe.moe_forward(cfg, p, xl, mesh=m22, mode=mode,
                                 prenorm=(T(a["norm"]), None))
        res[f"moe/{impl}/{cf}/{mode}/out"] = o
        res[f"moe/{impl}/{cf}/{mode}/aux"] = aux
    dense = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             impl="dense"))
    res[f"moe/{impl}/{cf}/dense"] = moe.moe_forward(
        dense, full, xl, prenorm=(T(a["norm"]), None))[0]

# the collective GEMM over the (1, 4) mesh's 'model' axis
with obs.capture() as rec:
    for v in ("all_gather", "reduce_scatter"):
        for k in ("g", "d"):
            for plan in ("ring", "gather"):
                res[f"gemm/{v}/{k}/{plan}"] = gemm_collective_sharded(
                    T(a[k + "x"]), T(a[k + "w"]), mesh=m14, variant=v,
                    plan=plan)
            res[f"gemm/{v}/{k}/oracle"] = gemm_collective_oracle(
                T(a[k + "x"]), T(a[k + "w"]), variant=v, axis_size=4)
res["gemm/counters"] = dict(rec.counters)
# plan=None: the autotuner's verdict, then the verdict a table pins
from repro_torch.core import autotune as _at
from repro_torch.distributed.sharding import ShardSpec as _Shard
_gx, _gw = T(a["gx"]), T(a["gw"])
_shard = _Shard.for_axis(m14, "model", dim="rows", collective="all_gather")
_auto = _at.select_fusion("gemm_collective", (_gx.shape[0], _gw.shape[1],
                                              _gx.shape[1]), _gx.dtype,
                          shard=_shard)["plan"]
_pin = "unfused" if _auto == "fused" else "fused"
_key = _at.pretuned_fusion_key(
    "gemm_collective", (1 << (_gx.shape[0] - 1).bit_length(), _gw.shape[1],
                        _gx.shape[1]), "float32", residual=True,
    prenorm="none", backward=False, causal=False, softcap=False,
    sink=False, shard=_shard)
for tag, table in (("auto", None), ("pinned", {
        "schema_version": 1, "arch": "cpu", "cells": {},
        "fusion": {_key: {"plan": {"plan": _pin}}}})):
    if table is not None:
        assert _at.install_pretuned(table, arch="cpu")
    with obs.capture() as rec:
        res[f"gemm/plan_none/{tag}/out"] = gemm_collective_sharded(
            _gx, _gw, mesh=m14, variant="all_gather", plan=None)
    res[f"gemm/plan_none/{tag}"] = (
        {"fused": "ring", "unfused": "gather"}[_pin if table else _auto],
        dict(rec.counters))
_at.clear_pretuned()

# compressed_psum over 'data' of the (2, 2) mesh
res["psum/replicated"] = compressed_psum(T(a["px"]), m22, "data")
res["psum/own"] = compressed_psum(T(a["prank"][rank]), m22, "data")

# DataIterator's rows
dcfg = DataConfig(vocab_size=256, seq_len={TS}, global_batch={TB})
res["rows/41"] = next(DataIterator(dcfg, device="cpu", mesh=m41))
res["rows/22"] = next(DataIterator(dcfg, device="cpu", mesh=m22))

# the ZeRO-1 data-parallel trainer on the (4, 1) mesh
tcfg = dataclasses.replace(get_config("llama-1b"), compute_dtype="float32",
                           **{SMALL})
model = build_model(tcfg, mode="kernel", device="cpu", mesh=m41)
params = params_from_numpy(nest({k[6:]: v for k, v in a.items()
                                 if k.startswith("param/")}), "cpu",
                           torch.float32)
for gc in (False, True):
    for z in (False, True):
        kw = {}
        if z and not gc:
            kw = dict(ckpt_dir=f"{d}/ckpt", ckpt_every={STEPS})
        out = train_loop(model, DataIterator(dcfg, device="cpu", mesh=m41),
                         {STEPS}, AdamWConfig(schedule=cosine_schedule(
                             1e-2, 2, {STEPS})), params=params, mesh=m41,
                         zero1=z, grad_compress=gc, log_every=0,
                         log=lambda *a: None, **kw)
        res[f"train/{gc}/{z}/losses"] = out.losses
        res[f"train/{gc}/{z}/params"] = dict(named_leaves(
            out.state["params"]))
        if z:
            res[f"train/{gc}/{z}/m_shape"] = tuple(
                out.state["opt"]["m"]["embed"].shape)
# the step-3 checkpoint (global leaves) restored under the (2, 2) mesh:
# each rank's blocks, gathered back, are the saved leaves bit for bit
specs = state_shardings(model, m22, zero1=True)
tmpl = sharded_init(model, 0, m22, zero1=True)
local, step = ckpt.restore(f"{d}/ckpt", tmpl, mesh=m22, specs=specs)
whole = gather_tree(local, specs, m22)
with np.load(f"{d}/ckpt/step_{step:08d}/arrays.npz") as saved:
    res["elastic/equal"] = all(
        np.array_equal(np.asarray(saved[k]), t.detach().numpy()
                       if torch.is_tensor(t) else np.asarray(t))
        for k, t in named_leaves(whole))
    res["elastic/keys"] = sorted(saved.files) == sorted(
        k for k, _ in named_leaves(whole))
res["elastic/step"] = step
res["elastic/local_wqk"] = tuple(local["params"]["blocks"]["attn"]["wqk"]
                                 .shape)

# both engines serve mixtral's smoke config built over the mesh (ep over
# 'model', the experts cut to the rank's), against the unsharded model
scfg = get_config("mixtral-8x7b", smoke=True)
scfg = dataclasses.replace(scfg, compute_dtype="float32", moe=dataclasses
                           .replace(scfg.moe, capacity_factor=16.0,
                                    impl="ep"))
plain = build_model(dataclasses.replace(scfg, moe=dataclasses.replace(
    scfg.moe, impl="dense")), mode="kernel", device="cpu")
meshed = build_model(scfg, mode="kernel", device="cpu", mesh=m22)
wts = plain.init(3)
prompts = np.random.default_rng(5).integers(0, scfg.vocab_size, (2, 12))
with torch.inference_mode():
    res["serve/plain"] = Engine(plain, wts, max_len=32).generate(
        prompts, 6).tokens
    res["serve/mesh"] = Engine(meshed, meshed.local_params(wts),
                               max_len=32).generate(prompts, 6).tokens
    pe = PagedEngine(meshed, meshed.local_params(wts), batch_slots=2,
                     page_size=8, max_pages_per_seq=4)
    for i, pr in enumerate(prompts):
        pe.submit(Request(uid=i, prompt=pr, max_new_tokens=6))
    res["serve/paged"] = pe.run()
torch.save(res, f"{d}/out_{rank}.pt")
dist.destroy_process_group()
'''


def _fill(code, d):
    return (code.replace("{DIR}", str(d)).replace("{CASES}", repr(CASES))
            .replace("{MOE}", repr(MOE)).replace("{SMALL}", repr(SMALL))
            .replace("{V}", str(SMALL["vocab_size"]))
            .replace("{TS}", str(TS)).replace("{TB}", str(TB))
            .replace("{STEPS}", str(STEPS)))


@pytest.fixture(scope="module")
def world(tmp_path_factory, subproc):
    """(the 4 ranks' results, the JAX references): the gloo world runs
    beside the JAX subprocess."""
    d = tmp_path_factory.mktemp("dist")
    _np_inputs(d / "inputs.npz")
    worker = d / "worker.py"
    worker.write_text(_fill(WORKER, d))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r),
                               str(WORLD), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    try:
        subproc(_fill(JAX, d), devices=4, timeout=600)
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    ranks = [torch.load(d / f"out_{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, dict(np.load(d / "jax.npz")), dict(np.load(
        d / "inputs.npz"))


def _by_data(ranks, key):
    """The (2, 2) mesh's outputs joined over 'data' (from model rank 0),
    after checking the model ranks agree bit for bit."""
    blocks = {}
    for r in ranks:
        blocks.setdefault(r["coords"][0], []).append(r[key])
    for same in blocks.values():
        assert all(torch.equal(same[0], t) for t in same[1:])
    return torch.cat([blocks[i][0] for i in sorted(blocks)]).numpy()


@pytest.mark.parametrize("impl,cf", CASES)
@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_moe_matches_jax_on_the_mesh(world, impl, cf, mode):
    """moe_ep / moe_tp on (2, 2) against the JAX moe_ep / moe_tp on the
    same mesh and inputs: fp32 within 1e-5 (outputs and aux), drops at
    capacity factor 1.0 included."""
    ranks, ref, _ = world
    got = _by_data(ranks, f"moe/{impl}/{cf}/{mode}/out")
    np.testing.assert_allclose(got, ref[f"moe/{impl}/{cf}/out"], rtol=1e-5,
                               atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(float(r[f"moe/{impl}/{cf}/{mode}/aux"]),
                                   float(ref[f"moe/{impl}/{cf}/aux"]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["ep", "tp"])
def test_moe_without_drops_is_dense_and_drops_show(world, impl):
    """At capacity factor 4.0 nothing drops: within 1e-4 of moe_dense; at
    1.0 the buckets overflow, so the output leaves moe_dense's."""
    ranks, _, _ = world
    got = _by_data(ranks, f"moe/{impl}/4.0/reference/out")
    dense = _by_data(ranks, f"moe/{impl}/4.0/dense")
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)
    dropped = _by_data(ranks, f"moe/{impl}/1.0/reference/out")
    assert np.abs(dropped - _by_data(ranks, f"moe/{impl}/1.0/dense")
                  ).max() > 1e-2


@pytest.mark.parametrize("variant", ["all_gather", "reduce_scatter"])
def test_gemm_collective_ring_equals_gather_and_oracle(world, variant):
    """Ring == gather == the port's oracle bit for bit on every rank
    (random fp32); the JAX oracle within 1e-5 there, and bit for bit on
    dyadic inputs (every sum exact)."""
    ranks, ref, _ = world
    for k in ("g", "d"):
        for rank, r in enumerate(ranks):
            ring = r[f"gemm/{variant}/{k}/ring"]
            assert torch.equal(ring, r[f"gemm/{variant}/{k}/gather"])
            oracle = r[f"gemm/{variant}/{k}/oracle"]
            want = oracle if variant == "all_gather" else oracle[rank]
            assert torch.equal(ring, want)
            jref = ref[f"oracle/{variant}/{k}"]
            jref = jref if variant == "all_gather" else jref[rank]
            if k == "d":
                assert np.array_equal(ring.numpy(), jref)
            else:
                np.testing.assert_allclose(ring.numpy(), jref, rtol=1e-5,
                                           atol=1e-4)


def test_gemm_collective_counts_and_refuses_plan_none(world):
    """Each plan counted; ``plan=None`` (refused before the policy layer)
    runs the plan ``core.autotune.select_fusion`` names, and under an
    installed table the plan the table pins, each bit for bit the other
    plan's product (full-K panels)."""
    ranks, _, _ = world
    for r in ranks:
        for v in ("all_gather", "reduce_scatter"):
            for plan in ("ring", "gather"):
                assert r["gemm/counters"][f"gemm_collective.{v}.{plan}"] == 2
        picked = []
        for tag in ("auto", "pinned"):
            plan, counters = r[f"gemm/plan_none/{tag}"]
            assert counters.get(f"gemm_collective.all_gather.{plan}") == 1
            assert torch.equal(r[f"gemm/plan_none/{tag}/out"],
                               r[f"gemm/all_gather/g/{plan}"])
            picked.append(plan)
        assert picked[0] != picked[1]


def test_compressed_psum_matches_jax(world):
    """A replicated input against the JAX compressed_psum on the same mesh
    within 1e-6; each rank's own input against a numpy emulation of the
    reference's body (the max of the data group's scales, the int8 values
    summed in int32) within 1e-6."""
    ranks, ref, inputs = world
    for r in ranks:
        np.testing.assert_allclose(r["psum/replicated"].numpy(), ref["psum"],
                                   rtol=1e-6, atol=1e-6)
    xs = inputs["prank"]
    for i, r in enumerate(ranks):
        group = [j for j in range(WORLD)
                 if ranks[j]["coords"][1] == r["coords"][1]]
        assert len(group) == 2
        scale = max(np.float32(np.abs(xs[j]).max()) / np.float32(127.0)
                    + np.float32(1e-12) for j in group)
        total = sum(np.clip(np.round(xs[j] / scale), -127, 127
                            ).astype(np.int32) for j in group)
        want = total.astype(np.float32) * scale
        np.testing.assert_allclose(r["psum/own"].numpy(), want, rtol=1e-6,
                                   atol=1e-6)


def test_data_iterator_rows_join_to_the_global_batch(world):
    """Over (4, 1) each rank holds one row, over (2, 2) each data rank two
    (the model ranks the same): joined, the global batch bit for bit."""
    from repro_torch.data import DataConfig, batch_at
    ranks, _, _ = world
    full = batch_at(DataConfig(vocab_size=256, seq_len=TS, global_batch=TB),
                    0)
    for key in full:
        joined = np.concatenate([r["rows/41"][key].numpy() for r in ranks])
        assert np.array_equal(joined, full[key].astype(joined.dtype))
        by_data = {r["coords"][0]: r["rows/22"][key].numpy() for r in ranks}
        joined = np.concatenate([by_data[i] for i in sorted(by_data)])
        assert np.array_equal(joined, full[key].astype(joined.dtype))


@pytest.mark.parametrize("gc", [False, True], ids=["exact", "compressed"])
def test_zero1_trainer_matches_the_jax_unsharded_step(world, gc):
    """3 data-parallel steps over (4, 1), ZeRO-1, the same weights and
    data: the global loss curve against the JAX trainer's unsharded steps
    on the global batch, at tests/test_torch_train.py's tolerance (2e-3);
    every rank reports the same curve and holds the same params."""
    ranks, ref, _ = world
    want = ref[f"curve/{gc}"]
    for r in ranks:
        got = np.asarray(r[f"train/{gc}/True/losses"], np.float64)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        assert r[f"train/{gc}/True/losses"] == ranks[0][
            f"train/{gc}/True/losses"]
        for k, t in r[f"train/{gc}/True/params"].items():
            assert torch.equal(t, ranks[0][f"train/{gc}/True/params"][k]), k
        # the moments are each rank's quarter of the leaf
        assert r[f"train/{gc}/True/m_shape"] == (SMALL["vocab_size"],
                                                  SMALL["d_model"] // WORLD)


@pytest.mark.parametrize("gc", [False, True], ids=["exact", "compressed"])
def test_zero1_on_and_off_are_bitwise_equal(world, gc):
    ranks, _, _ = world
    for r in ranks:
        assert r[f"train/{gc}/True/losses"] == r[f"train/{gc}/False/losses"]
        on, off = r[f"train/{gc}/True/params"], r[f"train/{gc}/False/params"]
        assert sorted(on) == sorted(off)
        for k in on:
            assert torch.equal(on[k], off[k]), k


def test_sharded_checkpoint_restores_under_another_mesh(world):
    """The ZeRO-1 run's step-3 checkpoint (written once, global leaves)
    restored under (2, 2): each rank's blocks (wqk cut over 'model')
    gathered back equal the saved leaves bit for bit."""
    ranks, _, _ = world
    for r in ranks:
        assert r["elastic/equal"] and r["elastic/keys"]
        assert r["elastic/step"] == STEPS
        # llama-1b's head_dim (64) at 4 + 2 heads, cut over 'model'
        hd = get_config("llama-1b").head_dim
        assert r["elastic/local_wqk"] == (SMALL["num_layers"],
                                          SMALL["d_model"], 6 * hd // 2)


def test_engines_serve_a_model_built_over_the_mesh(world):
    """mixtral's smoke config with impl 'ep' over the (2, 2) mesh, each
    rank holding its experts: Engine's and PagedEngine's greedy streams
    equal the unsharded model's (capacity 16.0: nothing drops)."""
    ranks, _, _ = world
    for r in ranks:
        plain = np.asarray(r["serve/plain"])
        assert np.array_equal(np.asarray(r["serve/mesh"]), plain)
        for uid, toks in r["serve/paged"].items():
            assert np.array_equal(np.asarray(toks)[-6:], plain[uid, -6:])


def test_logical_axes_reach_the_model():
    """``Model.axes()``: mixtral's experts are sharded by their FFN dim,
    maverick's by expert (the reference's ``moe.shard``)."""
    from repro_torch.models import build_model
    for arch, want in (("mixtral-8x7b", (None, "embed", "ffn")),
                       ("llama4-maverick-400b-a17b", ("expert", "embed",
                                                      None))):
        axes = build_model(get_config(arch), device="cpu").axes()
        moe_axes = [v["moe"]["w_in"] for v in axes.values()
                    if isinstance(v, dict) and "moe" in v]
        assert moe_axes and all(a == ("layers",) + want for a in moe_axes)
