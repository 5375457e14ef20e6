"""The port's tensor-parallel training step for the families beyond the
dense LM, on the CPU: one gloo world of 4 processes, spawned once for the
module (a ``file://`` store under the module's temporary directory), beside
one JAX subprocess (one device) for every reference number. Weights and
batches are made with numpy from a seed and handed to both sides.

The families, each at its smoke config in fp32: internvl2-2b ('vlm'),
bert-110m at ``test_bert_mlm_smoke``'s width with a vocab of 250 (the
'encoder': its tied table splits over 2 ranks and runs whole over 4),
whisper-base ('encdec': self and cross attention split by heads),
recurrentgemma-2b (('rg', 'rg', 'local'): the RG-LRU's channels, the local
attention's single kv head gathered) and mamba2-130m ('ssm': the
head-aligned ``in_proj``). On the ('data', 'model') meshes (2, 2) and
(1, 4):

* 3 steps (``make_train_step(mesh=)``, ZeRO-1): losses and updated params
  against the JAX unsharded step on the global batch (2e-3) and the port's
  single-device step (losses 5e-5, params 2e-3);
* every leaf's cross-entropy grad in both modes against the single-device
  grad (1e-4 of the leaf's largest, the floor 1e-3 of the model's largest);
* the replicated leaves bit for bit across the 'model' ranks;
* the 'model' collectives a step (printed with the test's output: the
  counts PERF.md quotes);
* the RG-LRU's row-split gate sum and the split block at extents 1 (bit for
  bit), 2 and 4;
* the ``in_proj`` layout: a round trip bit for bit, the rank's block
  holding its own heads, a (2, 2) checkpoint restored under (1, 4) and by
  the JAX package's ``restore`` bit for bit.

Plus, in one process: the permutation at mamba2-130m's published width.
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
TB, TS, STEPS = 4, 48, 3
# name -> (arch, smoke, replacements)
FAMS = {
    "vlm": ("internvl2-2b", True, {}),
    "bert": ("bert-110m", False, dict(num_layers=2, d_model=64, num_heads=4,
                                      num_kv_heads=4, d_ff=128,
                                      vocab_size=250, max_seq_len=64)),
    "whisper": ("whisper-base", True, {}),
    "rg": ("recurrentgemma-2b", True, {}),
    "ssm": ("mamba2-130m", True, {}),
}
MESHES = ("22", "14")

# the config maker, pasted into both sides (``get_config`` is the
# package's own on each side)
MAKE = r'''
def make_cfg(get_config, name):
    arch, smoke, kw = FAMS[name]
    return dataclasses.replace(get_config(arch, smoke=smoke),
                               compute_dtype="float32", **kw)
'''


def _np_inputs(path):
    """Weights by each leaf's init kind (ones and zeros perturbed by 0.1
    of a normal, so a per-channel leaf's entries differ; Λ as the
    reference draws it; matrices at std fan_in^-1/2 over their input dim)
    and STEPS global batches (loss masks of ~60% ones), per family."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    ns = {"FAMS": FAMS, "dataclasses": dataclasses}
    exec(MAKE, ns)
    rng = np.random.default_rng(7)
    arrays = {}
    for name in FAMS:
        cfg = ns["make_cfg"](get_config, name)
        defs = build_model(cfg, mode="reference", device="cpu").defs
        for key, d_ in sorted(defs.items()):
            if d_.init in ("ones", "zeros"):
                w = (float(d_.init == "ones")
                     + 0.1 * rng.standard_normal(d_.shape))
            elif d_.init == "lru_a":
                u = rng.uniform(0.9, 0.999, d_.shape)
                w = np.log(u / (1 - u))
            else:
                fan_in = (d_.shape[-1] if key in ("embed", "pos", "dec_pos")
                          else d_.shape[-2])
                w = rng.standard_normal(d_.shape) / np.sqrt(fan_in)
            arrays[f"p/{name}/{key}"] = w.astype(np.float32)
        for step in range(STEPS):
            pre = f"b/{name}/{step}/"
            if cfg.family == "vlm":
                arrays[pre + "patch_embeds"] = rng.standard_normal(
                    (TB, cfg.num_patches, cfg.d_model)).astype(np.float32)
            if cfg.family == "encdec":
                arrays[pre + "encoder_embeds"] = rng.standard_normal(
                    (TB, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            for k in ("inputs", "targets"):
                arrays[pre + k] = rng.integers(0, cfg.vocab_size, (TB, TS))
            arrays[pre + "loss_mask"] = (rng.uniform(size=(TB, TS)) < 0.6
                                         ).astype(np.float32)
    np.savez(path, **arrays)


JAX = r'''
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import build_model
from repro.models.common import nest
from repro.optim import optimizer as jopt
from repro.train import init_state, make_train_step
FAMS = {FAMS}
''' + MAKE + r'''
a = dict(np.load("{DIR}/inputs.npz"))
out = {}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree)}

for name in FAMS:
    cfg = make_cfg(get_config, name)
    pre = f"p/{name}/"
    params = nest({k[len(pre):]: jnp.asarray(v) for k, v in a.items()
                   if k.startswith(pre)})
    model = build_model(cfg, mode="reference")
    model.init = lambda rng, params=params: jax.tree.map(jnp.array, params)
    opt = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 2, {STEPS}))
    state = init_state(model, jax.random.PRNGKey(0))
    step = make_train_step(model, opt)
    curve = []
    for s in range({STEPS}):
        b = f"b/{name}/{s}/"
        batch = {k[len(b):]: jnp.asarray(v) for k, v in a.items()
                 if k.startswith(b)}
        state, m = step(state, batch)
        curve.append(float(m["loss"]))
    out[f"curve/{name}"] = np.asarray(curve, np.float64)
    for k, v in flat(state["params"]).items():
        out[f"params/{name}/{k}"] = v
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
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (gather_tree, layout_of,
                                              local_tree, mesh_coords)
from repro_torch.distributed.tensor_parallel import TensorParallel
from repro_torch.models import build_model, params_from_numpy, rglru, ssm
from repro_torch.models.common import nest
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.optim.optimizer import leaves, named_leaves
from repro_torch.train import init_state, make_train_step, train_loop
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import sharded_init, state_shardings
from repro_torch.train.trainer import _grad, _tokens
FAMS = {FAMS}
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


def rows_of(mesh):
    if mesh is None:
        return slice(None)
    nd = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    c = mesh_coords(mesh)["data"]
    return slice(c * {TB} // nd, (c + 1) * {TB} // nd)


class Feed:
    """The family's numpy batches, step by step (over a mesh, the rank's
    rows of each)."""

    def __init__(self, name, mesh=None):
        self.name, self.rows, self.step = name, rows_of(mesh), 0

    def __iter__(self):
        return self

    def batch(self, step):
        pre = f"b/{self.name}/{step}/"
        return {k[len(pre):]: T(v)[self.rows] for k, v in a.items()
                if k.startswith(pre)}

    def __next__(self):
        self.step += 1
        return self.batch(self.step - 1)

    def load_state_dict(self, sd):
        self.step = int(sd["step"])


def ce_grads(cfg, mode, params, batch, mesh=None):
    """The cross entropy's grads: single-device on the global batch, or
    this rank's over the mesh summed over 'data' and gathered to the
    global leaves."""
    model = build_model(cfg, mode=mode, device="cpu", mesh=mesh)
    if mesh is None:
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in named_leaves(params)}
        loss, _ = model.loss(nest(p), batch)
        return dict(zip(p, _grad(loss, list(p.values()))))
    run = dataclasses.replace(model, data_axes=(),
                              tp=TensorParallel(model, mesh))
    st = sharded_init(model, 0, mesh, zero1=False, params=params)
    dg = mesh.get_group("data")
    count = _tokens(batch)
    share = count / col.ordered_sum(count, dg)
    _, m = run.loss(st["params"], batch)
    names = [k for k, _ in named_leaves(st["params"])]
    g = _grad(m["ce"] * share, leaves(st["params"]))
    tree = nest(dict(zip(names, [col.ordered_sum(x, dg) for x in g])))
    whole = gather_tree(tree, state_shardings(model, mesh)["params"], mesh)
    return dict(named_leaves(whole))


def run_steps(model, st, step, feed):
    out = []
    for _ in range({STEPS}):
        _, m = step(st, next(feed))
        out.append(float(m["loss"]))
    return out


for name in FAMS:
    cfg = make_cfg(get_config, name)
    pre = f"p/{name}/"
    params = params_from_numpy(nest({k[len(pre):]: v for k, v in a.items()
                                     if k.startswith(pre)}), "cpu",
                               torch.float32)
    one = build_model(cfg, mode="kernel", device="cpu")
    st = init_state(one, params=params)
    res[f"{name}/single/curve"] = run_steps(one, st, make_train_step(
        one, opt()), Feed(name))
    res[f"{name}/single/params"] = {k: t.detach()
                                    for k, t in named_leaves(st["params"])}
    glob = Feed(name).batch(0)
    truth = {mode: ce_grads(cfg, mode, params, glob)
             for mode in ("reference", "kernel")}
    for mname, mesh in MESHES.items():
        key = f"{name}/{mname}"
        model = build_model(cfg, mode="kernel", device="cpu", mesh=mesh)
        st = sharded_init(model, 0, mesh, zero1=True, params=params)
        step = make_train_step(model, opt(), mesh=mesh, zero1=True)
        with obs.capture() as rec:
            res[key + "/curve"] = run_steps(model, st, step, Feed(name, mesh))
        res[key + "/counters"] = {k: v / {STEPS}
                                  for k, v in rec.counters.items()}
        whole = gather_tree(st, state_shardings(model, mesh, zero1=True),
                            mesh)
        res[key + "/params"] = {k: t.detach()
                                for k, t in named_leaves(whole["params"])}
        res[key + "/local"] = {k: t.detach()
                               for k, t in named_leaves(st["params"])}
        rows = Feed(name, mesh).batch(0)
        for mode in ("reference", "kernel"):
            got = ce_grads(cfg, mode, params, rows, mesh)
            res[f"{key}/grads/{mode}"] = {
                k: (float((got[k] - t).abs().max()), float(t.abs().max()))
                for k, t in truth[mode].items()}

# the RG-LRU's row-split gate sum and the split block over extents 1, 2, 4
cfg = make_cfg(get_config, "rg")
gen = torch.Generator().manual_seed(0)
w = cfg.rglru.lru_width
p = {k.rsplit("/", 1)[-1]: T(v[0]) for k, v in a.items()
     if k.startswith("p/rg/blocks_0/rec/")}
x = torch.randn(2, 40, cfg.d_model, generator=gen)
u = torch.randn(2, 40, w, generator=gen)
want = rglru._gates(cfg, p, u)
want_out = rglru.rglru_forward(cfg, p, x)
for mname, mesh in (("41", m41), ("22", MESHES["22"]), ("14", MESHES["14"])):
    model = build_model(cfg, mode="reference", device="cpu", mesh=mesh)
    tp = TensorParallel(model, mesh)
    ch = slice(tp.rank * w // tp.n, (tp.rank + 1) * w // tp.n)
    # the leaves as the rank holds them: the width-split ones its block
    held = {k: (v[:, ch] if k in ("proj_x", "proj_gate")
                else v[ch] if k in ("proj_out", "w_a", "w_i") else v)
            for k, v in p.items()}
    local = tp.rglru_params(held)
    got = rglru._gates(cfg, local, u[..., ch].contiguous(), tp)
    out = rglru.split_rglru_forward(cfg, held, x, tp)
    res[f"gates/{mname}"] = (
        tp.n, [(g_ - w_[..., ch]).abs().max().item()
               for g_, w_ in zip(got, want)],
        [torch.equal(g_, w_[..., ch]) for g_, w_ in zip(got, want)],
        (out - want_out).abs().max().item(), torch.equal(out, want_out),
        sorted(k for k, v in local.items() if v.shape != held[k].shape))

# the Mamba2 split block over extents 1, 2, 4: the rank's in_proj columns
# (its segments) and out_proj rows as held, the other leaves whole
cfg = make_cfg(get_config, "ssm")
p = {k.rsplit("/", 1)[-1]: T(v[0]) for k, v in a.items()
     if k.startswith("p/ssm/blocks/ssm/")}
x = torch.randn(2, 40, cfg.d_model, generator=gen)
want_out = ssm.ssm_forward(cfg, p, x)
for mname, mesh in (("41", m41), ("22", MESHES["22"]), ("14", MESHES["14"])):
    model = build_model(cfg, mode="reference", device="cpu", mesh=mesh)
    tp = TensorParallel(model, mesh)
    segs = ssm.in_proj_segments(cfg, tp.n, tp.rank)
    cols = torch.cat([torch.arange(c.start, c.stop) for c in segs])
    held = dict(p, in_proj=p["in_proj"][:, cols],
                out_proj=p["out_proj"][segs[0].start:segs[0].stop])
    out = ssm.split_ssm_forward(cfg, held, x, tp)
    res[f"ssm/{mname}"] = (tp.n, (out - want_out).abs().max().item(),
                           torch.equal(out, want_out),
                           want_out.abs().max().item())

# the in_proj layout on (2, 2) and (1, 4), carried by the state's specs; a
# (2, 2) checkpoint of 3 steps restored under (1, 4)
cfg = make_cfg(get_config, "ssm")
params = params_from_numpy(nest({k[len("p/ssm/"):]: v for k, v in a.items()
                                 if k.startswith("p/ssm/")}), "cpu",
                           torch.float32)
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
    res[f"layout/{mname}/in_proj"] = loc["blocks"]["ssm"]["in_proj"]
mesh = MESHES["22"]
model = build_model(cfg, mode="kernel", device="cpu", mesh=mesh)
out = train_loop(model, Feed("ssm", mesh), {STEPS}, opt(), params=params,
                 mesh=mesh, zero1=True, ckpt_dir=f"{d}/ckpt",
                 ckpt_every={STEPS}, log_every=0, log=quiet)
res["ckpt/losses"] = out.losses
with np.load(f"{d}/ckpt/step_%08d/arrays.npz" % {STEPS}) as saved:
    want = {k: saved[k] for k in saved.files}
m14 = MESHES["14"]
mdl = build_model(cfg, mode="kernel", device="cpu", mesh=m14)
specs = state_shardings(mdl, m14, zero1=True)
st, step = ckpt.restore(f"{d}/ckpt", sharded_init(mdl, 5, m14, zero1=True),
                        mesh=m14, specs=specs)
back = gather_tree(st, specs, m14)
res["restore/14"] = (step, all(
    np.array_equal(want[k], t.detach().numpy() if torch.is_tensor(t)
                   else np.asarray(t)) for k, t in named_leaves(back)),
    sorted(want) == sorted(k for k, _ in named_leaves(back)))
torch.save(res, f"{d}/out_{rank}.pt")
dist.destroy_process_group()
'''


def _fill(code, d):
    return (code.replace("{DIR}", str(d)).replace("{FAMS}", repr(FAMS))
            .replace("{TS}", str(TS)).replace("{TB}", str(TB))
            .replace("{STEPS}", str(STEPS)))


@pytest.fixture(scope="module")
def world(tmp_path_factory, subproc):
    """(the 4 ranks' results, the JAX references, the directory): the gloo
    world runs beside the JAX subprocess."""
    d = tmp_path_factory.mktemp("tpf")
    _np_inputs(d / "inputs.npz")
    worker = d / "worker.py"
    worker.write_text(_fill(WORKER, d))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r),
                               str(WORLD), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    try:
        subproc(_fill(JAX, d), devices=1, timeout=600)
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


RUNS = [(name, mesh) for name in FAMS for mesh in MESHES]


@pytest.mark.parametrize("name,mesh", RUNS)
def test_steps_match_the_jax_unsharded_step(world, name, mesh):
    """3 split steps (``make_train_step(mesh=)``, ZeRO-1 over 'data'):
    every rank's loss curve and the gathered updated params against the
    JAX trainer's unsharded steps on the global batch (2e-3), and against
    the port's single-device steps (the curve 5e-5, the params 2e-3, as
    the dense LM's split steps are held)."""
    ranks, ref, _ = world
    want = ref[f"curve/{name}"]
    for r in ranks:
        got = np.asarray(r[f"{name}/{mesh}/curve"], np.float64)
        single = np.asarray(r[f"{name}/single/curve"], np.float64)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(single, want, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got, single, rtol=5e-5, atol=5e-5)
        for k, t in r[f"{name}/{mesh}/params"].items():
            np.testing.assert_allclose(t.numpy(), ref[f"params/{name}/{k}"],
                                       rtol=2e-3, atol=2e-3, err_msg=k)
            np.testing.assert_allclose(t.numpy(), r[f"{name}/single/params"]
                                       [k].numpy(), rtol=2e-3, atol=2e-3,
                                       err_msg=k)


@pytest.mark.parametrize("name,mesh", RUNS)
@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_every_grad_matches_the_single_device_grad(world, name, mesh, mode):
    """The cross entropy's grad of every leaf, each rank's summed over
    'data' and gathered over 'model', against the single-device grad on
    the global batch: within 1e-4 of the leaf's largest grad (floored at
    1e-3 of the model's largest)."""
    ranks, _, _ = world
    for r in ranks:
        errs = r[f"{name}/{mesh}/grads/{mode}"]
        top = max(scale for _, scale in errs.values())
        for k, (diff, scale) in errs.items():
            assert diff <= 1e-4 * max(scale, 1e-3 * top), (k, diff, scale)


# the leaves the rules split over 'model' in every family at both extents
# (bert's table and the other per-channel leaves aside)
SPLIT = {"vlm": "blocks/attn/wqk", "bert": "enc/mlp/w_in",
         "whisper": "dec/xattn/wqk", "rg": "blocks_0/rec/w_a",
         "ssm": "blocks/ssm/in_proj"}


@pytest.mark.parametrize("name,mesh", RUNS)
def test_replicated_leaves_stay_bitwise_equal_over_model(world, name, mesh):
    """After the steps every leaf the rules replicate over 'model' (norms,
    positions, the RG-LRU's and Mamba2's per-channel leaves, the
    convolutions, bert's table over 4 ranks) holds the same bits on each
    'model' rank of a 'data' row; the split leaves differ."""
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
        assert SPLIT[name] in split
        assert any("norm" in k or "ln" in k for k in same)
        for k in same:
            leaf = k.rsplit("/", 1)[-1]
            assert ("norm" in k or "ln" in k or "pos" in k
                    or leaf in ("conv_w", "conv_b", "b_a", "b_i", "lambda",
                                "a_log", "d_skip", "dt_bias")
                    or (name, mesh, k) == ("bert", "14", "embed")), k


def test_collectives_a_step(world):
    """The 'model' collectives and gathered leaves of one split step (f,
    g, gathers and reduce-scatters, the forward's and the backward's,
    counted over 'model' only), printed for PERF.md; the local attention's
    single kv head gathered at both extents, nothing gathered elsewhere."""
    ranks, _, _ = world
    for name in FAMS:
        for mesh in MESHES:
            c = ranks[0][f"{name}/{mesh}/counters"]
            print(f"{name} {mesh}: {c.get('tp.collectives', 0):g} "
                  f"collectives, {c.get('tp.gathered_leaves', 0):g} "
                  f"gathered leaves a step")
            assert c.get("tp.collectives", 0) > 0
            gathered = c.get("tp.gathered_leaves", 0)
            assert (gathered > 0) == (name == "rg" or
                                      (name, mesh) == ("vlm", "14")), (
                name, mesh, gathered)


@pytest.mark.parametrize("mesh", ["41", "22", "14"])
def test_rglru_row_split_gates(world, mesh):
    """The RG-LRU's gate products on a rank's rows of ``w_a``/``w_i``,
    summed over the ranks in rank order and cut to its channels, and the
    split block (``split_rglru_forward``) against the whole block: bit for
    bit at extent 1, within fp32's order of summation at 2 and 4; the
    block's width-split leaves taken as held, the others through f."""
    ranks, _, _ = world
    for r in ranks:
        n, errs, equal, out_err, out_equal, narrowed = r[f"gates/{mesh}"]
        assert n == {"41": 1, "22": 2, "14": 4}[mesh]
        if n == 1:
            assert all(equal) and out_equal, (errs, out_err)
        assert max(errs) <= 1e-6 and out_err <= 1e-5, (errs, out_err)
        assert narrowed == ([] if n == 1 else
                            ["b_a", "b_i", "conv_b", "conv_w", "lambda"])


@pytest.mark.parametrize("mesh", ["41", "22", "14"])
def test_ssm_split_block(world, mesh):
    """The Mamba2 block on a rank's heads (``split_ssm_forward``: its
    ``in_proj`` segments, the B|C output gathered, the gated RMSNorm's mean
    square summed over the ranks, ``out_proj`` partials through g) against
    the whole block: bit for bit at extent 1, within fp32's order of
    summation at 2 and 4."""
    ranks, _, _ = world
    for r in ranks:
        n, err, equal, big = r[f"ssm/{mesh}"]
        assert n == {"41": 1, "22": 2, "14": 4}[mesh]
        if n == 1:
            assert equal, err
        assert err <= 1e-5 * max(1.0, big), (err, big)


def test_select_joins_adjacent_ranges():
    """``_select`` over ranges: adjacent ones are one narrowed view (a run
    of the whole dim is the leaf itself, no copy), others are joined in
    turn."""
    from repro_torch.distributed.tensor_parallel import _select

    x = torch.arange(24.0).reshape(4, 6)
    whole = _select(x, 1, (range(0, 2), range(2, 6)))
    assert whole.data_ptr() == x.data_ptr() and torch.equal(whole, x)
    rows = _select(x, 0, (range(1, 2), range(2, 4)))
    assert rows.data_ptr() == x[1:].data_ptr() and torch.equal(rows, x[1:])
    assert torch.equal(_select(x, 1, (range(0, 2), range(4, 6))),
                       x[:, [0, 1, 4, 5]])
    assert torch.equal(_select(x, 1, range(3, 5)), x[:, 3:5])
    assert torch.equal(_select(x, 1, [5, 0]), x[:, [5, 0]])


def test_in_proj_layout_round_trips(world):
    """The head-aligned ``in_proj`` carried by the state's specs: cut then
    gathered, every leaf bit for bit; the rank's block is its z heads, its
    x heads, its 2GN / n of the B|C columns and its dt heads."""
    ranks, _, d = world
    full = dict(np.load(d / "inputs.npz"))["p/ssm/blocks/ssm/in_proj"]
    di, bc, h = 128, 32, 4
    for r in ranks:
        for mesh, n in (("22", 2), ("14", 4)):
            assert r[f"layout/{mesh}/equal"]
            assert r[f"layout/{mesh}/permuted"] == ["blocks/ssm/in_proj"]
            m = r["coords"][mesh]["model"]
            cols = np.r_[m * di // n:(m + 1) * di // n,
                         di + m * di // n:di + (m + 1) * di // n,
                         2 * di + m * bc // n:2 * di + (m + 1) * bc // n,
                         2 * di + bc + m * h // n:
                         2 * di + bc + (m + 1) * h // n]
            assert np.array_equal(r[f"layout/{mesh}/in_proj"].numpy(),
                                  full[..., cols])


def test_in_proj_checkpoint_restores_under_another_mesh(world):
    """The (2, 2) run's checkpoint (the reference's layout: gathered and
    un-permuted) restored under (1, 4): gathered back, every leaf bit for
    bit; and through the JAX package's restore, bit for bit."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    from repro.train import checkpoint as j_ckpt
    from repro.train.state import init_state as j_init_state

    ranks, ref, d = world
    for r in ranks:
        step, equal, keys = r["restore/14"]
        assert step == STEPS and equal and keys
        np.testing.assert_allclose(r["ckpt/losses"], ref["curve/ssm"],
                                   rtol=2e-3, atol=2e-3)
    arch, smoke, kw = FAMS["ssm"]
    jcfg = dataclasses.replace(j_get_config(arch, smoke=smoke),
                               compute_dtype="float32", **kw)
    jstate = j_init_state(j_build_model(jcfg, mode="reference"),
                          jax.random.PRNGKey(0))
    tpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       jstate)
    back, step = j_ckpt.restore(str(d / "ckpt"), tpl)
    assert step == STEPS
    with np.load(d / "ckpt" / f"step_{STEPS:08d}" / "arrays.npz") as saved:
        for k, v in j_ckpt._flatten(back).items():
            assert np.array_equal(np.asarray(v), saved[k]), k


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_in_proj_permutation_at_published_width(n):
    """mamba2-130m's packed ``in_proj`` (3352 columns: z and x 1536 each,
    B|C 256, dt 24) over n ranks: a permutation whose block r holds rank
    r's z heads, x heads, B|C columns and dt heads (838 columns at n 4),
    the identity layout (None) at n 1; the leaf permuted and un-permuted
    bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import permute_dim
    from repro_torch.distributed.tensor_parallel import ssm_permutation

    cfg = get_config("mamba2-130m")
    perm = ssm_permutation(cfg, n)
    if n == 1:
        assert perm is None
        return
    di, bc, h = 1536, 256, 24
    assert sorted(perm.tolist()) == list(range(2 * di + bc + h))
    blocks = perm.reshape(n, -1)
    assert blocks.shape[1] == 3352 // n
    for r, blk in enumerate(blocks):
        z, x = di // n, di // n
        assert np.array_equal(blk[:z], np.arange(r * z, (r + 1) * z))
        assert np.array_equal(blk[z:2 * z], di + np.arange(r * x, (r + 1) * x))
        b = bc // n
        assert np.array_equal(blk[2 * z:2 * z + b],
                              2 * di + np.arange(r * b, (r + 1) * b))
        assert np.array_equal(blk[2 * z + b:],
                              2 * di + bc + np.arange(r * h // n,
                                                      (r + 1) * h // n))
    leaf = torch.randn(3, 2 * di + bc + h)
    there = permute_dim(leaf, 1, perm)
    assert torch.equal(permute_dim(there, 1, perm, inverse=True), leaf)


def test_ssm_groups_that_cut_a_ranks_heads_are_refused():
    """The B|C groups a rank's heads read: its G / n groups where the
    extent divides G, its one group where its heads lie in one, None where
    the extent does not divide the heads or 2GN (the block then runs
    whole); 12 heads in 6 groups over 4 ranks (3 heads a rank across
    groups of 2) raise, naming the shape."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.tensor_parallel import _ssm_groups

    base = get_config("mamba2-130m", smoke=True)
    cfg = dataclasses.replace(base, d_model=96, ssm=dataclasses.replace(
        base.ssm, head_dim=16, n_groups=6))
    assert _ssm_groups(cfg, 2, 1) == (3, 3, 2)
    assert _ssm_groups(cfg, 3, 2) == (4, 2, 2)
    assert _ssm_groups(base, 4, 3) == (0, 1, 1)
    assert _ssm_groups(cfg, 5, 0) is None
    with pytest.raises(NotImplementedError, match=r"12 heads in 6 B\|C "
                       r"groups do not split over a 'model' extent of 4"):
        _ssm_groups(cfg, 4, 0)
