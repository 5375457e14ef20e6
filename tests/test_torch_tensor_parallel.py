"""The port's tensor-parallel training step on the CPU: one gloo world of 4
processes, spawned once for the module (a ``file://`` store under the
module's temporary directory), beside one JAX subprocess on 4 forced host
devices for every reference number. Inputs are made with numpy from a seed
and handed to both sides.

Covered, on the ('data', 'model') meshes (2, 2) and (1, 4) (the latter at
Hkv 2 < 4: the packed q|k and the v leaves are gathered for each use):

* 3 steps of the dense LM (tied, untied, and untied with
  ``embed_shard="embed"``), mixtral's smoke stack through ``moe_ep`` and
  ``moe_tp`` at capacity 4.0 (nothing drops) and maverick's interleaved
  ('attn', 'moe') smoke stack: losses and updated params against the JAX
  unsharded step on the global batch (2e-3, as ``test_torch_distributed``
  holds the data-parallel trainer; the MoE's with its 'dense' impl, its
  aux term each shard's: see the test), and against the port's
  single-device step (5e-5 on the losses, 2e-3 on the params); the MoE
  configs again with the aux term's weight 0, held as the dense ones;
* every leaf's grad of the cross entropy in both modes against the port's
  single-device grad (1e-4 of each leaf's largest, the floor at 1e-3 of
  the model's largest: fp32 runs of this model sit 2.2e-4 from a float64
  run); the MoE's aux term is each shard's, as the reference's, so it is
  held apart: ``moe_ep``/``moe_tp``'s grads at capacity 1.0 (drops) with
  the aux term against ``jax.grad`` through the JAX ``moe_forward`` on
  the same mesh;
* the replicated leaves bit for bit across 'model' ranks after the steps;
* the head-aligned q|k layout's round trip, bit for bit, and the rank's
  block holding its own heads;
* a (2, 2) checkpoint restored under (4, 1) and (1, 4) bit for bit (and by
  the JAX package's ``restore``, in the test process);
* 2 microbatches on (2, 2) against 1 (equal parts), and microbatches
  over uneven loss masks on (2, 2) and (4, 1) against the JAX trainer's
  microbatched step and the port's single-device one;
* the remaining refusal (a 'pod' axis; every family and block kind now
  splits over 'model': ``test_torch_tensor_parallel_families.py``).

Plus, in one process: a resume hashes each kept checkpoint once.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD = 4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             d_ff=256, vocab_size=256)
TB, TS, STEPS = 4, 64, 3
# name -> (arch, smoke, replacements; a MoE's as (impl, capacity factor))
CFGS = {
    "tied": ("llama-1b", False, dict(SMALL)),
    "untied": ("llama-1b", False, dict(SMALL, tie_embeddings=False)),
    "embed": ("llama-1b", False, dict(SMALL, tie_embeddings=False,
                                      embed_shard="embed")),
    "moe_ep": ("mixtral-8x7b", True, dict(moe=("ep", 4.0))),
    "moe_tp": ("mixtral-8x7b", True, dict(moe=("tp", 4.0))),
    "maverick": ("llama4-maverick-400b-a17b", True, dict(moe=("ep", 8.0))),
}
# the MoE layer alone at capacity 1.0 (drops), as tests/test_torch_distributed
MOE = dict(name="t", family="lm", num_layers=1, d_model=64, num_heads=4,
           num_kv_heads=2, d_ff=128, vocab_size=64, block_pattern=("moe",))
MB, MS = 4, 64
# the MoE configs trained again with the aux term's weight 0 (the whole
# update then is the unsharded model's on every mesh), and for how many
# steps: maverick's for one (its top-1 router's weight is 1 whatever the
# logits, so without the aux term the router's grad is rounding noise,
# which AdamW turns into steps of the learning rate: from the second step
# on even the port's single-device run sits 2.2e-3 from the JAX curve)
NOAUX = {"moe_ep": STEPS, "moe_tp": STEPS, "maverick": 1}
# microbatches over uneven loss masks (short documents: every row's loss
# tokens differ): the global batch and the data config's other fields,
# and the parts: 4 over (2, 2) (2 parts of a rank in each of the
# reference's microbatches) and 2 over (4, 1) (2 ranks' parts in each)
UNEVEN = dict(global_batch=8, mean_doc_len=8)
UNEVEN_PARTS = {4: "22", 2: "41"}

# the config maker, pasted into both sides (``MoEConfig`` and ``get_config``
# are the package's own on each side)
MAKE = r'''
def make_cfg(get_config, MoEConfig, name, impl=None):
    arch, smoke, kw = CFGS[name]
    kw = dict(kw)
    cfg = get_config(arch, smoke=smoke)
    if "moe" in kw:
        mi, cf = kw.pop("moe")
        mi = impl or mi
        kw["moe"] = MoEConfig(num_experts=8, top_k=cfg.moe.top_k,
                              capacity_factor=cf, impl=mi,
                              shard="ffn" if mi == "tp" else "expert")
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)
'''


def _np_inputs(path):
    from repro.configs import get_config as j_get_config
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models.lm import lm_param_defs

    ns = {"CFGS": CFGS, "dataclasses": dataclasses}
    exec(MAKE, ns)
    rng = np.random.default_rng(11)
    arrays = {}
    for name in CFGS:
        jcfg = ns["make_cfg"](j_get_config, JMoEConfig, name, impl="dense")
        for key, d_ in sorted(lm_param_defs(jcfg).items()):
            if d_.init == "ones":
                w = np.ones(d_.shape, np.float32)
            elif d_.init == "zeros":
                w = np.zeros(d_.shape, np.float32)
            else:
                fan_in = d_.shape[-1] if key == "embed" else d_.shape[-2]
                w = (rng.standard_normal(d_.shape) / np.sqrt(fan_in)
                     ).astype(np.float32)
            arrays[f"p/{name}/{key}"] = w
    e, d, f = 8, MOE["d_model"], MOE["d_ff"]
    arrays.update({
        "m/x": rng.standard_normal((MB, MS, d)).astype(np.float32),
        "m/probe": rng.standard_normal((MB, MS, d)).astype(np.float32),
        "m/router": rng.standard_normal((d, e)).astype(np.float32),
        "m/w_in": (rng.standard_normal((e, d, f)) / np.sqrt(d)
                   ).astype(np.float32),
        "m/w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)
                     ).astype(np.float32),
        "m/w_out": (rng.standard_normal((e, f, d)) / np.sqrt(f)
                    ).astype(np.float32),
        "m/norm": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
    })
    np.savez(path, **arrays)


JAX = r'''
import dataclasses, functools, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ModelConfig, MoEConfig
from repro.models import build_model
from repro.models.common import nest
from repro.models.moe import moe_forward
from repro.optim import optimizer as jopt
from repro.data import pipeline as jdata
from repro.train import init_state, make_train_step
CFGS = {CFGS}
NOAUX = {NOAUX}
UNEVEN, UNEVEN_PARTS = {UNEVEN}, {UNEVEN_PARTS}
''' + MAKE + r'''
a = dict(np.load("{DIR}/inputs.npz"))
out = {}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree)}

def train(name, tag, aux=True, microbatches=1, n_steps={STEPS}, **data):
    cfg = make_cfg(get_config, MoEConfig, name, impl="dense")
    pre = f"p/{name}/"
    params = nest({k[len(pre):]: jnp.asarray(v) for k, v in a.items()
                   if k.startswith(pre)})
    model = build_model(cfg, mode="reference")
    if not aux:
        model = dataclasses.replace(
            model, loss=functools.partial(model.loss, aux_weight=0.0))
    model.init = lambda rng, params=params: jax.tree.map(jnp.array, params)
    dcfg = jdata.DataConfig(vocab_size=cfg.vocab_size, seq_len={TS},
                            **dict(dict(global_batch={TB}), **data))
    opt = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 2, {STEPS}))
    state = init_state(model, jax.random.PRNGKey(0))
    step = make_train_step(model, opt, microbatches=microbatches)
    it, curve = jdata.DataIterator(dcfg), []
    for _ in range(n_steps):
        state, m = step(state, next(it))
        curve.append((float(m["loss"]), float(m["ce"])))
    out[f"curve/{tag}"] = np.asarray(curve, np.float64)
    for k, v in flat(state["params"]).items():
        out[f"params/{tag}/{k}"] = v

for name in CFGS:
    train(name, name)
for name, n_steps in NOAUX.items():
    train(name, f"{name}/noaux", aux=False, n_steps=n_steps)
for n in UNEVEN_PARTS:
    train("tied", f"uneven/{n}", microbatches=n, **UNEVEN)

mesh = jax.make_mesh((2, 2), ("data", "model"))
x, probe = jnp.asarray(a["m/x"]), jnp.asarray(a["m/probe"])
for impl in ("ep", "tp"):
    cfg = ModelConfig(**{MOE}, moe=MoEConfig(num_experts=8, top_k=2,
        capacity_factor=1.0, impl=impl,
        shard="expert" if impl == "ep" else "ffn"))
    p = {k: jnp.asarray(a["m/" + k])
         for k in ("router", "w_in", "w_gate", "w_out")}

    def f(p, x, norm):
        o, aux = moe_forward(cfg, p, x, mesh=mesh, mode="reference",
                             prenorm=(norm, None))
        return jnp.sum(o * probe) + aux

    with jax.set_mesh(mesh):
        gp, gx, gn = jax.grad(f, argnums=(0, 1, 2))(
            p, x, jnp.asarray(a["m/norm"]))
    out[f"moe/{impl}/x"], out[f"moe/{impl}/norm"] = np.asarray(gx), np.asarray(gn)
    for k, v in gp.items():
        out[f"moe/{impl}/{k}"] = np.asarray(v)
np.savez("{DIR}/jax.npz", **out)
print("OK")
'''


WORKER = r'''
import dataclasses, os, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.data import DataConfig, DataIterator, batch_at
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (gather_tree, layout_of,
                                              local_tree, mesh_coords)
from repro_torch.distributed.tensor_parallel import TensorParallel
from repro_torch.models import build_model, lm, moe, params_from_numpy
from repro_torch.models.common import nest
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.optim.optimizer import leaves, named_leaves
from repro_torch.train import init_state, make_train_step, train_loop
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import sharded_init, state_shardings
from repro_torch.train.trainer import _grad, _tokens
CFGS = {CFGS}
NOAUX = {NOAUX}
UNEVEN, UNEVEN_PARTS = {UNEVEN}, {UNEVEN_PARTS}
''' + MAKE + r'''
a = dict(np.load(f"{d}/inputs.npz"))
T = torch.from_numpy
quiet = lambda *a, **k: None
MESHES = {"22": init_device_mesh("cpu", (2, 2),
                                 mesh_dim_names=("data", "model")),
          "14": init_device_mesh("cpu", (1, 4),
                                 mesh_dim_names=("data", "model"))}
m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
res = {"coords": {k: mesh_coords(m) for k, m in MESHES.items()}}


def opt():
    return AdamWConfig(schedule=cosine_schedule(1e-2, 2, {STEPS}))


def steps(step, state, it, n={STEPS}):
    """n steps in place: [(loss, ce)] of each."""
    out = []
    for _ in range(n):
        _, m = step(state, next(it))
        out.append((float(m["loss"]), float(m["ce"])))
    return out


def ce_grads(cfg, mode, params, batch, mesh=None):
    """The cross entropy's grads (aux excluded): single-device on the
    global batch, or this rank's over the mesh summed over 'data' and
    gathered to the global leaves."""
    if mesh is None:
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in named_leaves(params)}
        loss, _ = lm.lm_loss(cfg, nest(p), batch, mode=mode, aux_weight=0.0)
        return dict(zip(p, _grad(loss, list(p.values()))))
    model = build_model(cfg, mode=mode, device="cpu", mesh=mesh)
    tp = TensorParallel(model, mesh)
    st = sharded_init(model, 0, mesh, zero1=False, params=params)
    dg = mesh.get_group("data")
    count = _tokens(batch)
    share = count / col.ordered_sum(count, dg)
    loss, m = lm.lm_loss(cfg, st["params"], batch, mode=mode, mesh=mesh,
                         data_axes=(), aux_weight=0.0, tp=tp)
    names = [k for k, _ in named_leaves(st["params"])]
    g = _grad(m["ce"] * share, leaves(st["params"]))
    tree = nest(dict(zip(names, [col.ordered_sum(x, dg) for x in g])))
    whole = gather_tree(tree, state_shardings(model, mesh)["params"], mesh)
    return dict(named_leaves(whole))


real_loss = lm.lm_loss


def no_aux(*args, **kw):
    return real_loss(*args, **dict(kw, aux_weight=0.0))


def mesh_run(cfg, params, dcfg, mesh, key, n={STEPS}):
    """n split steps of ``cfg`` over ``mesh`` (ZeRO-1): the curve, the
    gathered params and this rank's blocks under ``key``; the obs
    counters returned."""
    model = build_model(cfg, mode="kernel", device="cpu", mesh=mesh)
    st = sharded_init(model, 0, mesh, zero1=True, params=params)
    with obs.capture() as rec:
        curve = steps(make_train_step(model, opt(), mesh=mesh, zero1=True),
                      st, DataIterator(dcfg, device="cpu", mesh=mesh), n)
    whole = gather_tree(st, state_shardings(model, mesh, zero1=True), mesh)
    res[key + "/curve"] = curve
    res[key + "/params"] = {k: t.detach()
                            for k, t in named_leaves(whole["params"])}
    res[key + "/local"] = {k: t.detach()
                           for k, t in named_leaves(st["params"])}
    return dict(rec.counters)


def single_run(model, params, dcfg, key, n={STEPS}):
    st = init_state(model, params=params)
    res[key + "/curve"] = steps(make_train_step(model, opt()), st,
                                DataIterator(dcfg, device="cpu"), n)
    res[key + "/params"] = {k: t.detach()
                            for k, t in named_leaves(st["params"])}


for name in CFGS:
    cfg = make_cfg(get_config, MoEConfig, name)
    dense = make_cfg(get_config, MoEConfig, name, impl="dense")
    pre = f"p/{name}/"
    params = params_from_numpy(nest({k[len(pre):]: v for k, v in a.items()
                                     if k.startswith(pre)}), "cpu",
                               torch.float32)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len={TS},
                      global_batch={TB})
    one = build_model(dense, mode="kernel", device="cpu")
    single_run(one, params, dcfg, f"{name}/single")
    glob = {k: torch.as_tensor(v) for k, v in batch_at(dcfg, 0).items()}
    truth = {mode: ce_grads(dense, mode, params, glob)
             for mode in ("reference", "kernel")}
    for mname, mesh in MESHES.items():
        key = f"{name}/{mname}"
        res[key + "/counters"] = mesh_run(cfg, params, dcfg, mesh, key)
        rows = next(DataIterator(dcfg, device="cpu", mesh=mesh))
        for mode in ("reference", "kernel"):
            got = ce_grads(cfg, mode, params, rows, mesh)
            res[f"{key}/grads/{mode}"] = {
                k: (float((got[k] - t).abs().max()), float(t.abs().max()))
                for k, t in truth[mode].items()}
    if name in NOAUX:
        lm.lm_loss = no_aux
        try:
            n = NOAUX[name]
            single_run(one, params, dcfg, f"{name}/noaux/single", n)
            for mname, mesh in MESHES.items():
                mesh_run(cfg, params, dcfg, mesh, f"{name}/noaux/{mname}", n)
        finally:
            lm.lm_loss = real_loss

class EqualParts:
    """The data iterator's batches with every loss-mask entry 1 (every
    part of a batch holds as many loss tokens as any other)."""

    def __init__(self, it):
        self.it = it

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        return dict(b, loss_mask=torch.ones_like(b["loss_mask"]))

    def load_state_dict(self, sd):
        self.it.load_state_dict(sd)


# microbatches: 2 parts of each rank's rows against 1, on (2, 2), with
# equal parts (the mean of the parts' means is the batch's mean)
cfg = make_cfg(get_config, MoEConfig, "tied")
params = params_from_numpy(nest({k[len("p/tied/"):]: v for k, v in a.items()
                                 if k.startswith("p/tied/")}), "cpu",
                           torch.float32)
dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len={TS}, global_batch={TB})
mesh = MESHES["22"]
model = build_model(cfg, mode="kernel", device="cpu", mesh=mesh)
for mb in (1, 2):
    kw = dict(ckpt_dir=f"{d}/ckpt", ckpt_every={STEPS}) if mb == 1 else {}
    out = train_loop(model, EqualParts(DataIterator(dcfg, device="cpu",
                                                    mesh=mesh)),
                     {STEPS}, opt(), params=params, mesh=mesh, zero1=True,
                     microbatches=mb, log_every=0, log=quiet, **kw)
    res[f"micro/{mb}/losses"] = out.losses
    whole = gather_tree(out.state["params"], state_shardings(model, mesh)
                        ["params"], mesh)
    res[f"micro/{mb}/params"] = {k: t.detach()
                                 for k, t in named_leaves(whole)}

# microbatches over uneven loss masks: over the mesh and on one device
ucfg = DataConfig(vocab_size=cfg.vocab_size, seq_len={TS}, **UNEVEN)
one = build_model(cfg, mode="kernel", device="cpu")
for n, mname in UNEVEN_PARTS.items():
    m = MESHES["22"] if mname == "22" else m41
    mdl = build_model(cfg, mode="kernel", device="cpu", mesh=m)
    for tag, model_, mesh_ in (("mesh", mdl, m), ("single", one, None)):
        out = train_loop(model_, DataIterator(ucfg, device="cpu",
                                              mesh=mesh_),
                         {STEPS}, opt(), params=params, mesh=mesh_,
                         zero1=True, microbatches=n, log_every=0, log=quiet)
        whole = out.state["params"] if mesh_ is None else gather_tree(
            out.state["params"], state_shardings(mdl, m)["params"], m)
        res[f"uneven/{n}/{tag}/losses"] = out.losses
        res[f"uneven/{n}/{tag}/params"] = {k: t.detach()
                                           for k, t in named_leaves(whole)}

# the head-aligned layout's round trip on (2, 2) and (1, 4), carried by the
# state's specs; a fresh split state saved with those specs alone
for mname, m in MESHES.items():
    mdl = build_model(cfg, mode="kernel", device="cpu", mesh=m)
    specs = state_shardings(mdl, m)["params"]
    loc = local_tree(params, specs, m)
    back = gather_tree(loc, specs, m)
    res[f"layout/{mname}/equal"] = all(
        torch.equal(x, y) for (_, x), (_, y) in zip(named_leaves(back),
                                                    named_leaves(params)))
    res[f"layout/{mname}/permuted"] = sorted(
        k for k, s in named_leaves(specs) if layout_of(s) is not None)
    res[f"layout/{mname}/wqk"] = loc["blocks"]["attn"]["wqk"]
    path = ckpt.save(sharded_init(mdl, 0, m, zero1=True, params=params),
                     f"{d}/fresh_{mname}", 0, mesh=m,
                     specs=state_shardings(mdl, m, zero1=True))
    with np.load(os.path.join(path, "arrays.npz")) as saved:
        res[f"layout/{mname}/saved"] = all(
            np.array_equal(saved["params/" + k], t.numpy())
            for k, t in named_leaves(params))

# the (2, 2) run's step-3 checkpoint restored under (4, 1) and (1, 4)
with np.load(f"{d}/ckpt/step_%08d/arrays.npz" % {STEPS}) as saved:
    want = {k: saved[k] for k in saved.files}
for mname, m in (("41", m41), ("14", MESHES["14"])):
    mdl = build_model(cfg, mode="kernel", device="cpu", mesh=m)
    specs = state_shardings(mdl, m, zero1=True)
    st, step = ckpt.restore(f"{d}/ckpt", sharded_init(mdl, 5, m, zero1=True),
                            mesh=m, specs=specs)
    back = gather_tree(st, specs, m)
    res[f"restore/{mname}"] = (step, all(
        np.array_equal(want[k], t.detach().numpy() if torch.is_tensor(t)
                       else np.asarray(t)) for k, t in named_leaves(back)),
        sorted(want) == sorted(k for k, _ in named_leaves(back)))

# the MoE layer alone at capacity 1.0 (drops): its grads with the aux term
c22 = mesh_coords(mesh)
for impl in ("ep", "tp"):
    mcfg = ModelConfig(**{MOE}, moe=MoEConfig(num_experts=8, top_k=2,
        capacity_factor=1.0, impl=impl,
        shard="expert" if impl == "ep" else "ffn"))
    full = {k: T(a["m/" + k]).requires_grad_(True)
            for k in ("router", "w_in", "w_gate", "w_out")}
    rows = slice(c22["data"] * 2, (c22["data"] + 1) * 2)
    x = T(a["m/x"])[rows].clone().requires_grad_(True)
    norm = T(a["m/norm"]).requires_grad_(True)
    o, aux = moe.moe_forward(mcfg, moe.local_experts(mcfg, full, mesh), x,
                             mesh=mesh, data_axes=(), mode="reference",
                             prenorm=(norm, None))
    obj = (o * T(a["m/probe"])[rows]).sum() + aux / 2
    grads = torch.autograd.grad(obj, [x, norm] + list(full.values()))
    dg, wg = mesh.get_group("data"), dist.group.WORLD
    res[f"moe1/{impl}/x"] = grads[0]
    res[f"moe1/{impl}/norm"] = col.ordered_sum(grads[1], dg)
    res[f"moe1/{impl}/router"] = col.ordered_sum(grads[2], dg)
    for k, g in zip(list(full)[1:], grads[3:]):
        res[f"moe1/{impl}/{k}"] = col.ordered_sum(g, wg)

# the refusals
refused = {}
pod = init_device_mesh("cpu", (1, 2, 2),
                       mesh_dim_names=("pod", "data", "model"))
for tag, arch, m in (("pod", "llama-1b", pod),):
    try:
        make_train_step(build_model(get_config(arch, smoke=True),
                                    device="cpu"), opt(), mesh=m)
        refused[tag] = None
    except NotImplementedError as e:
        refused[tag] = str(e)
res["refused"] = refused
torch.save(res, f"{d}/out_{rank}.pt")
dist.destroy_process_group()
'''


def _fill(code, d):
    return (code.replace("{DIR}", str(d)).replace("{CFGS}", repr(CFGS))
            .replace("{NOAUX}", repr(NOAUX)).replace("{UNEVEN}", repr(UNEVEN))
            .replace("{UNEVEN_PARTS}", repr(UNEVEN_PARTS))
            .replace("{MOE}", repr(MOE)).replace("{TS}", str(TS))
            .replace("{TB}", str(TB)).replace("{STEPS}", str(STEPS)))


@pytest.fixture(scope="module")
def world(tmp_path_factory, subproc):
    """(the 4 ranks' results, the JAX references, the checkpoint
    directory): the gloo world runs beside the JAX subprocess."""
    d = tmp_path_factory.mktemp("tp")
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
    return ranks, dict(np.load(d / "jax.npz")), d


RUNS = [(name, mesh) for name in CFGS for mesh in ("22", "14")]


@pytest.mark.parametrize("name,mesh", RUNS)
def test_steps_match_the_jax_unsharded_step(world, name, mesh):
    """3 split steps (``make_train_step(mesh=)``, ZeRO-1 over 'data'):
    every rank's (loss, ce) curve and the gathered updated params against
    the JAX trainer's unsharded steps on the global batch (2e-3), and
    against the port's single-device steps (the curve 5e-5, the params
    2e-3: AdamW's first steps move a leaf by about the learning rate
    whatever the grad's size, so a grad near zero carries fp32 noise into
    the params). A MoE's loss holds the aux term of each shard's tokens
    (the reference's ``moe_ep``/``moe_tp`` form, a pmean of the shards'
    terms), not the unsharded model's: its first step's cross entropy
    (the same params) is held as the dense's, its curves within 5e-3
    (maverick's at (1, 4), 16-token shards of a top-1 router, sit 3.1e-3
    from the JAX curve), and its params not at all: the aux grads' other
    form moves AdamW's steps wherever the cross entropy's grad is near
    zero. Where every rank routes the whole global batch (``moe_tp`` at
    (1, 4)) the aux term is the unsharded one, and the MoE is held as the
    dense configs are. Its cross entropy's grads are held leaf by leaf
    below, its whole update without the aux term
    (``test_moe_steps_without_aux_match_the_jax_unsharded_step``), and the
    aux path against ``jax.grad`` (``test_moe_grads_with_drops``)."""
    ranks, ref, _ = world
    want = ref[f"curve/{name}"]
    moe = "moe" in CFGS[name][2] and (name, mesh) != ("moe_tp", "14")
    for r in ranks:
        got = np.asarray(r[f"{name}/{mesh}/curve"], np.float64)
        single = np.asarray(r[f"{name}/single/curve"], np.float64)
        first = slice(0, 1) if moe else slice(None)
        np.testing.assert_allclose(got[first, 1], want[first, 1], rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(got[first, 1], single[first, 1],
                                   rtol=5e-5, atol=5e-5)
        if moe:
            for other in (want, single):
                np.testing.assert_allclose(got, other, rtol=5e-3, atol=5e-3)
            continue
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got, single, rtol=5e-5, atol=5e-5)
        for k, t in r[f"{name}/{mesh}/params"].items():
            np.testing.assert_allclose(t.numpy(), ref[f"params/{name}/{k}"],
                                       rtol=2e-3, atol=2e-3, err_msg=k)
            np.testing.assert_allclose(t.numpy(), r[f"{name}/single/params"]
                                       [k].numpy(), rtol=2e-3, atol=2e-3,
                                       err_msg=k)


@pytest.mark.parametrize("name,mesh", [(name, mesh) for name in NOAUX
                                       for mesh in ("22", "14")])
def test_moe_steps_without_aux_match_the_jax_unsharded_step(world, name,
                                                           mesh):
    """The MoE configs' split steps with the aux term's weight 0 on both
    sides (each shard's aux term then has no part in the update; 3 steps,
    maverick's 1: see ``NOAUX``): every rank's curve and the gathered
    updated params against the JAX trainer's unsharded steps (2e-3) and
    against the port's single-device steps (the curve 5e-5, the params
    2e-3), as the dense configs are held; maverick's routers, whose update
    is AdamW's step on rounding noise, aside."""
    ranks, ref, _ = world
    want = ref[f"curve/{name}/noaux"]
    for r in ranks:
        got = np.asarray(r[f"{name}/noaux/{mesh}/curve"], np.float64)
        single = np.asarray(r[f"{name}/noaux/single/curve"], np.float64)
        assert len(got) == NOAUX[name]
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got, single, rtol=5e-5, atol=5e-5)
        for k, t in r[f"{name}/noaux/{mesh}/params"].items():
            if name == "maverick" and k.endswith("router"):
                continue
            np.testing.assert_allclose(t.numpy(),
                                       ref[f"params/{name}/noaux/{k}"],
                                       rtol=2e-3, atol=2e-3, err_msg=k)
            np.testing.assert_allclose(
                t.numpy(), r[f"{name}/noaux/single/params"][k].numpy(),
                rtol=2e-3, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("name,mesh", RUNS)
@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_every_grad_matches_the_single_device_grad(world, name, mesh, mode):
    """The cross entropy's grad of every leaf, each rank's summed over
    'data' and gathered over 'model', against the single-device grad on
    the global batch: within 1e-4 of the leaf's largest grad (floored at
    1e-3 of the model's largest, for maverick's top-1 router, whose cross
    entropy grad is rounding noise)."""
    ranks, _, _ = world
    for r in ranks:
        errs = r[f"{name}/{mesh}/grads/{mode}"]
        top = max(scale for _, scale in errs.values())
        for k, (diff, scale) in errs.items():
            assert diff <= 1e-4 * max(scale, 1e-3 * top), (k, diff, scale)


@pytest.mark.parametrize("name,mesh", RUNS)
def test_replicated_leaves_stay_bitwise_equal_over_model(world, name, mesh):
    """After the steps every leaf the rules replicate over 'model' (the
    norms, the router, and at (1, 4) nothing split by a misfit) holds the
    same bits on each 'model' rank of a 'data' row; the split leaves
    differ (each rank its block)."""
    ranks, _, _ = world
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coords"][mesh]["data"], []).append(
            r[f"{name}/{mesh}/local"])
    for group in by_data.values():
        first = group[0]
        same = {k for k, t in first.items()
                if all(t.shape == o[k].shape and torch.equal(t, o[k])
                       for o in group[1:])}
        split = {k for k, t in first.items() if k not in same}
        assert "final_norm_scale" in same
        assert any(k.endswith("wqk") for k in split)
        for k in same:
            assert "norm" in k or "ln" in k or k.endswith("router"), k


def test_split_leaves_gather_counts(world):
    """(1, 4) gathers the misfit q|k and v leaves for each use (an obs
    counter per gather); (2, 2) holds every attention leaf head-aligned
    and gathers nothing."""
    ranks, _, _ = world
    for r in ranks:
        assert "tp.gathered_leaves" not in r["tied/22/counters"]
        assert r["tied/14/counters"]["tp.gathered_leaves"] > 0
        assert r["tied/22/counters"]["tp.collectives"] > 0


def test_head_aligned_layout_round_trips(world):
    """The permutation at the state's edges, carried by the state's specs:
    cut then gathered, every leaf bit for bit; at (2, 2) the packed q|k
    leaves are permuted and the rank's block holds its two q heads then
    its k head; at (1, 4) (Hkv 2 < 4) nothing is permuted. A fresh split
    state saved with ``save(mesh=, specs=)`` alone holds the reference's
    layout, bit for bit."""
    ranks, _, d = world
    inputs = dict(np.load(d / "inputs.npz"))
    full = inputs["p/tied/blocks/attn/wqk"]
    hd = 64
    for r in ranks:
        assert r["layout/22/equal"] and r["layout/14/equal"]
        assert r["layout/22/saved"] and r["layout/14/saved"]
        assert r["layout/22/permuted"] == ["blocks/attn/wqk"]
        assert r["layout/14/permuted"] == []
        m = r["coords"]["22"]["model"]
        cols = np.r_[m * 2 * hd:(m + 1) * 2 * hd,
                     4 * hd + m * hd:4 * hd + (m + 1) * hd]
        assert np.array_equal(r["layout/22/wqk"].numpy(), full[..., cols])


def test_checkpoint_restores_under_other_meshes(world):
    """The (2, 2) run's checkpoint (the reference's layout: gathered and
    un-permuted) restored under (4, 1) and (1, 4): gathered back, every
    leaf bit for bit; and through the JAX package's restore, bit for
    bit."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    from repro.train import checkpoint as j_ckpt
    from repro.train.state import init_state as j_init_state

    ranks, _, d = world
    for r in ranks:
        for m in ("41", "14"):
            step, equal, keys = r[f"restore/{m}"]
            assert step == STEPS and equal and keys
    jcfg = dataclasses.replace(j_get_config("llama-1b"),
                               compute_dtype="float32", **SMALL)
    jstate = j_init_state(j_build_model(jcfg, mode="reference"),
                          jax.random.PRNGKey(0))
    tpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       jstate)
    back, step = j_ckpt.restore(str(d / "ckpt"), tpl)
    assert step == STEPS
    with np.load(d / "ckpt" / f"step_{STEPS:08d}" / "arrays.npz") as saved:
        for k, v in j_ckpt._flatten(back).items():
            assert np.array_equal(np.asarray(v), saved[k]), k


def test_microbatches_match_one_batch(world):
    """2 microbatches of each rank's rows on (2, 2) through
    ``train_loop(mesh=)``, every loss-mask entry 1 (so the mean of the
    parts' means, the reference's objective, is the batch's mean): the
    losses of 1 within fp32's order of summation (1e-6), the params
    within 1e-4 (AdamW carries that order's noise on near-zero grads into
    a step of up to the learning rate)."""
    ranks, _, _ = world
    for r in ranks:
        np.testing.assert_allclose(r["micro/2/losses"], r["micro/1/losses"],
                                   rtol=1e-6, atol=1e-6)
        for k, t in r["micro/2/params"].items():
            np.testing.assert_allclose(t.numpy(), r["micro/1/params"][k]
                                       .numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("n", sorted(UNEVEN_PARTS))
def test_microbatches_follow_the_reference_with_uneven_masks(world, n):
    """n microbatches over loss masks whose microbatches hold different
    numbers of loss tokens (asserted): 4 over (2, 2), where each of a
    rank's parts lies in one of the reference's microbatches, and 2 over
    (4, 1), where each microbatch spans two ranks. The losses and params
    of ``train_loop(mesh=)`` against the JAX trainer's microbatched steps
    on the global batch (the mean of the microbatches' masked means;
    2e-3), and against the port's single-device microbatched steps (the
    losses 5e-5, the params 2e-3, as the split steps are held above)."""
    from repro_torch.data import DataConfig, batch_at

    ranks, ref, _ = world
    dcfg = DataConfig(vocab_size=SMALL["vocab_size"], seq_len=TS, **UNEVEN)
    for step in range(STEPS):
        mask = batch_at(dcfg, step)["loss_mask"]
        counts = mask.reshape(n, -1).sum(axis=1)
        assert len(set(counts.tolist())) > 1, (step, counts)
    want = ref[f"curve/uneven/{n}"][:, 0]
    for r in ranks:
        got = np.asarray(r[f"uneven/{n}/mesh/losses"])
        single = np.asarray(r[f"uneven/{n}/single/losses"])
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(single, want, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got, single, rtol=5e-5, atol=5e-5)
        for k, t in r[f"uneven/{n}/mesh/params"].items():
            np.testing.assert_allclose(t.numpy(),
                                       ref[f"params/uneven/{n}/{k}"],
                                       rtol=2e-3, atol=2e-3, err_msg=k)
            np.testing.assert_allclose(t.numpy(), r[f"uneven/{n}/single/"
                                                    f"params"][k].numpy(),
                                       rtol=2e-3, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("impl", ["ep", "tp"])
def test_moe_grads_with_drops_match_jax(world, impl):
    """The MoE layer alone at capacity 1.0 (buckets overflow) over (2, 2),
    the aux term included: the grads of x, the norm scale, the router and
    the experts (summed over the ranks) against ``jax.grad`` through the
    JAX moe_forward on the same mesh, within 1e-5 of each's largest."""
    ranks, ref, _ = world
    for r in ranks:
        rows = slice(r["coords"]["22"]["data"] * 2,
                     (r["coords"]["22"]["data"] + 1) * 2)
        for k in ("x", "norm", "router", "w_in", "w_gate", "w_out"):
            want = ref[f"moe/{impl}/{k}"]
            want = want[rows] if k == "x" else want
            got = r[f"moe1/{impl}/{k}"].numpy()
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k


def test_the_remaining_refusals(world):
    """Only a 'pod' axis is refused, naming its ROADMAP item (every family
    and block kind splits over 'model')."""
    ranks, _, _ = world
    for r in ranks:
        ref = r["refused"]
        assert list(ref) == ["pod"]
        assert "'pod' axis" in ref["pod"] and "ROADMAP" in ref["pod"]


def test_a_resume_hashes_each_checkpoint_once(tmp_path, monkeypatch):
    """``train_loop`` resuming from a directory of 3 kept checkpoints reads
    each payload's sha256 once (``available_steps``); ``restore`` with the
    step it was handed hashes none again."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, constant_schedule
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_loop

    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=1,
                              d_model=64, num_heads=2, num_kv_heads=1,
                              d_ff=128, vocab_size=64,
                              compute_dtype="float32")
    model = build_model(cfg, mode="reference", device="cpu")
    dcfg = DataConfig(vocab_size=64, seq_len=16, global_batch=2)

    def run(steps):
        return train_loop(model, DataIterator(dcfg, device="cpu"), steps,
                          AdamWConfig(schedule=constant_schedule(1e-3)),
                          ckpt_dir=str(tmp_path), ckpt_every=1,
                          log_every=0, log=lambda *a: None)

    run(3)
    kept = sorted(os.listdir(tmp_path))
    assert len(kept) == 3
    hashed = []
    real = ckpt._sha256
    monkeypatch.setattr(ckpt, "_sha256",
                        lambda path: hashed.append(path) or real(path))
    res = run(3)
    assert res.state["step"] == 3 and res.losses == []
    reads = [p for p in hashed if ".tmp_save_" not in p]
    assert sorted(reads) == sorted(str(tmp_path / k / "arrays.npz")
                                   for k in kept)
