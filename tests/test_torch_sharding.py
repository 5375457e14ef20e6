"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, in one process: the reference's own rule cases
ported; a parity sweep of every config at published shapes over four
meshes (specs and their fallback reports, ZeRO-1 and FSDP, the caches),
with meta tensors and abstract shapes only; ``local_slice`` round trips;
an elastic restore of a checkpoint, one written by the JAX package
included, from a (4, 2) to a (2, 4) mesh, bit for bit.

The reference's helpers build ``NamedSharding``s, which need a live jax
mesh; here its module's ``NamedSharding`` is replaced by a record of the
spec, so both packages run on the same mesh-like object.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as jsh
from repro.models import build_model as j_build_model
from repro.models.lm import _is_uniform
from repro.train import checkpoint as jckpt
from repro.train import init_state as j_init_state

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import build_model
from repro_torch.models import encdec as t_encdec
from repro_torch.models import lm as t_lm
from repro_torch.optim.optimizer import named_leaves
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.state import (abstract_params, init_state,
                                     sharded_init, state_shardings)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"2x4": {"data": 2, "model": 4}, "4x2": {"data": 4, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture
def jspec(monkeypatch):
    """The reference's helpers on a FakeMesh: NamedSharding -> its spec."""
    import repro.train.state as jstate
    for module in (jsh, jstate):
        monkeypatch.setattr(module, "NamedSharding", lambda mesh, spec:
                            types.SimpleNamespace(spec=spec))


def _t(spec):
    return tuple(spec)


# ---------------------------------------------------------------------------
# the reference's rule cases (tests/test_distributed.py), on the port
# ---------------------------------------------------------------------------

class TestSpecRules:
    def test_divisible_shards(self):
        mesh = FakeMesh({"data": 16, "model": 16})
        assert sh.spec_for((152064, 8192), ("vocab", "embed"), mesh) == \
            ("model", None)
        assert sh.spec_for((8192, 29568), ("embed", "ffn"), mesh) == \
            (None, "model")

    def test_indivisible_replicates(self):
        mesh = FakeMesh({"data": 16, "model": 16})
        report = []
        spec = sh.spec_for((51865, 512), ("vocab", "embed"), mesh,
                           report=report)
        assert spec == (None, None)
        assert report

    def test_batch_axes_compose(self):
        mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
        assert sh.spec_for((256, 4096), ("batch", None), mesh) == \
            (("pod", "data"), None)


class TestZero1Fsdp:
    def test_shard_free_dim_picks_largest(self):
        mesh = FakeMesh({"data": 1, "model": 1})
        out = sh._shard_free_dim((None, "model", None, None),
                                 (24, 128, 5120, 8192), mesh, "data")
        assert out is not None
        assert out[3] == "data" and out[1] == "model"

    def test_vocab_padding_config(self):
        cfg = dataclasses.replace(get_config("minicpm-2b"),
                                  vocab_pad_multiple=128)
        assert cfg.padded_vocab() % 128 == 0
        assert 0 <= cfg.padded_vocab() - cfg.vocab_size < 128


class TestShardSpec:
    def test_construction_and_describe(self):
        sp = sh.ShardSpec(mesh=(("model", 4),),
                          partition=(("expert", "model"),),
                          collective="all_to_all")
        assert sp.n_shards == 4 and sp.axis_size("model") == 4
        assert sp.describe() == "model=4|expert@model|all_to_all"
        assert hash(sp) == hash(sh.ShardSpec(
            mesh=(("model", 4),), partition=(("expert", "model"),),
            collective="all_to_all"))
        assert sp.describe() == jsh.ShardSpec(
            mesh=(("model", 4),), partition=(("expert", "model"),),
            collective="all_to_all").describe()

    def test_validation(self):
        with pytest.raises(ValueError):
            sh.ShardSpec(collective="broadcast")
        with pytest.raises(ValueError):
            sh.ShardSpec(mesh=(("model", 4),), partition=(("ffn", "tensor"),))
        with pytest.raises(ValueError):
            sh.ShardSpec(mesh=(("model", 0),))

    def test_for_axis_from_a_mesh(self):
        sp = sh.ShardSpec.for_axis(FakeMesh({"data": 1, "model": 1}), "model",
                                   dim="ffn", collective="all_reduce")
        assert sp.mesh == (("model", 1),) and sp.n_shards == 1

    @pytest.mark.parametrize("n_exp,want", [(8, "all_to_all"),
                                            (3, "all_reduce"),
                                            (None, "all_reduce")])
    def test_train_shard_spec_dispatch(self, n_exp, want):
        from repro_torch.configs.base import ModelConfig, MoEConfig
        from repro.configs.base import ModelConfig as JC, MoEConfig as JM
        mesh = FakeMesh({"data": 2, "model": 4})
        kw = dict(name="t", family="lm", num_layers=1, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
        if n_exp is None:
            tcfg, jcfg = ModelConfig(**kw), JC(**kw)
        else:
            tcfg = ModelConfig(**kw, block_pattern=("moe",),
                               moe=MoEConfig(num_experts=n_exp, top_k=2))
            jcfg = JC(**kw, block_pattern=("moe",),
                      moe=JM(num_experts=n_exp, top_k=2))
        sp = sh.train_shard_spec(tcfg, mesh)
        assert sp.collective == want and sp.n_shards == 4
        assert sp.describe() == jsh.train_shard_spec(jcfg, mesh).describe()
        assert sh.train_shard_spec(tcfg, FakeMesh({"data": 8})) is None
        assert sh.train_shard_spec(tcfg, None) is None


class TestShardingHelpers:
    def test_divisible_axes(self):
        mesh = FakeMesh({"pod": 2, "data": 4, "model": 2})
        assert sh.divisible_axes(16, mesh, ("pod", "data")) == ("pod",
                                                                "data")
        assert sh.divisible_axes(12, mesh, ("pod", "data")) is None
        assert sh.divisible_axes(12, mesh, ("data",)) == ("data",)
        assert sh.divisible_axes(16, FakeMesh({"model": 2}),
                                 ("pod", "data")) is None

    def test_leaf_nbytes(self):
        assert sh.leaf_nbytes(torch.zeros((4, 8))) == 128
        assert sh.leaf_nbytes(torch.empty((4, 8), dtype=torch.bfloat16,
                                          device="meta")) == 64
        assert sh.leaf_nbytes(jax.ShapeDtypeStruct((4, 8), jnp.bfloat16)) == \
            jsh.leaf_nbytes(jax.ShapeDtypeStruct((4, 8), jnp.bfloat16))

    def test_shard_free_dim_axis_already_used(self):
        mesh = FakeMesh({"data": 1, "model": 1})
        assert sh._shard_free_dim(("data", None), (8, 8), mesh) is None
        assert sh._shard_free_dim((("data", "model"), None), (8, 8),
                                  mesh) is None

    def test_shard_free_dim_no_divisible_dim(self):
        mesh = FakeMesh({"data": 3})
        assert sh._shard_free_dim((None, None), (4, 5), mesh) is None
        assert sh._shard_free_dim((None, None), (2, 1), mesh) is None

    def test_fsdp_min_bytes_cutoff(self):
        mesh = FakeMesh({"data": 1, "model": 1})
        spec = (None, None)
        out = sh.fsdp_shardings({"a": spec, "b": spec},
                                {"a": torch.zeros((4, 4)),
                                 "b": torch.empty((1024, 1024),
                                                  device="meta")},
                                mesh, min_bytes=2**20)
        assert out["a"] is spec
        assert "data" in out["b"]

    def test_fsdp_without_data_axis_is_identity(self):
        tree = {"a": (None, None)}
        assert sh.fsdp_shardings(tree, {"a": torch.zeros((8, 8))},
                                 FakeMesh({"model": 4})) is tree

    def test_batch_specs_fallback_replicates(self):
        out = sh.batch_specs({"x": torch.zeros((4, 8)),
                              "y": torch.zeros((3, 8))},
                             FakeMesh({"data": 2, "model": 1}))
        assert out == {"x": ("data", None), "y": (None, None)}

    def test_spec_for_reports_fallback(self):
        report = []
        spec = sh.spec_for((51865, 512), ("vocab", "embed"),
                           FakeMesh({"model": 16}), report=report)
        assert spec == (None, None)
        assert report[0][1] == "vocab" and report[0][3] == 16


# ---------------------------------------------------------------------------
# parity sweep: every config at published shapes over four meshes
# ---------------------------------------------------------------------------

def _jmodel(arch):
    return j_build_model(j_get_config(arch))


def _flat_j(tree):
    """{path: spec tuple} of a reference tree of spec records."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, types.SimpleNamespace))[0]
    return {"/".join(str(p.key) for p in path): _t(leaf.spec)
            for path, leaf in flat}


def _flat_t(tree):
    return dict(named_leaves(tree))


def _caches(arch):
    """(the port's cache as meta tensors, the reference's abstract cache,
    stacked) of a decoder or enc-dec config: batch 32, 4096 positions."""
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    jm = j_build_model(jcfg)
    if tcfg.family == "encdec":
        tc = t_encdec.encdec_init_cache(tcfg, 32, 448, "meta")
        jc = jax.eval_shape(lambda: jm.init_cache(32, 448))
    else:
        tc = t_lm.lm_init_cache(tcfg, 32, 4096, "meta")
        jc = jax.eval_shape(lambda: jm.init_cache(32, 4096))
    return tc, jc, jcfg.family == "encdec" or _is_uniform(jcfg)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(jspec, arch, mesh_id):
    """The logical axes, param specs and their fallback reports, ZeRO-1
    and FSDP specs of the moments and params, and the KV/state cache
    specs: the port's equal the reference's, leaf for leaf."""
    mesh = FakeMesh(MESHES[mesh_id])
    jm = _jmodel(arch)
    tm = build_model(get_config(arch), device="cpu")
    assert _flat_t(tm.axes()) == {
        "/".join(str(k.key) for k in path): axes
        for path, axes in jax.tree_util.tree_flatten_with_path(
            jm.axes(), is_leaf=lambda x: isinstance(x, tuple))[0]}
    jrep, trep = [], []
    jp = jsh.shardings_for_tree(jm.axes(), jm.abstract(), mesh, report=jrep)
    shapes = abstract_params(tm)
    tp = sh.shardings_for_tree(tm.axes(), shapes, mesh, report=trep)
    assert _flat_t(tp) == _flat_j(jp)
    assert trep == [(tuple(s), lg, d, n) for s, lg, d, n in jrep]
    assert _flat_t(sh.zero1_shardings(tp, shapes, mesh)) == _flat_j(
        jsh.zero1_shardings(jp, jm.abstract(), mesh))
    assert _flat_t(sh.fsdp_shardings(tp, shapes, mesh)) == _flat_j(
        jsh.fsdp_shardings(jp, jm.abstract(), mesh))
    if tm.family in ("lm", "vlm", "encdec"):
        tc, jc, stacked = _caches(arch)
        assert _flat_t(sh.cache_specs(tc, mesh, stacked=stacked)) == \
            _flat_j(jsh.cache_specs(jc, mesh, stacked=stacked))
    tb = {"inputs": torch.empty((256, 4096), device="meta")}
    jb = {"inputs": jax.ShapeDtypeStruct((256, 4096), jnp.int32)}
    assert _flat_t(sh.batch_specs(tb, mesh)) == _flat_j(
        jsh.batch_specs(jb, mesh))


def test_state_shardings_match_the_reference(jspec):
    """The train state's specs (params by the rules, moments ZeRO-1, the
    ints replicated) on granite-8b at (4, 2) equal the reference's
    ``state_shardings``."""
    from repro.train import state_shardings as j_state_shardings
    mesh = FakeMesh(MESHES["4x2"])
    jm = _jmodel("granite-8b")
    tm = build_model(get_config("granite-8b"), device="cpu")
    for zero1 in (False, True):
        got = _flat_t(state_shardings(tm, mesh, zero1=zero1))
        want = _flat_j(j_state_shardings(jm, mesh, zero1=zero1))
        assert got == want


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _assemble(blocks: dict, spec, mesh):
    """The full leaf from every rank's block (``blocks``: the rank's
    coordinates, in the mesh's axis order, -> its block), put back by
    ``local_slice``'s own indexing, then the layout a ``LaidOut`` spec
    carries undone."""
    names = mesh.axis_names
    some = next(iter(blocks.values()))
    shape = list(some.shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= sh.block_index(entry, mesh, {a: 0 for a in names})[1]
    out = some.new_empty(shape)
    for key, block in blocks.items():
        sh.local_slice(out, tuple(spec), mesh,
                       dict(zip(names, key))).copy_(block)
    layout = sh.layout_of(spec)
    return out if layout is None else sh.permute_dim(out, *layout,
                                                     inverse=True)


def _coords(mesh):
    names = mesh.axis_names
    grid = np.indices(tuple(mesh.shape[a] for a in names)).reshape(
        len(names), -1).T
    return [dict(zip(names, map(int, c))) for c in grid]


@pytest.mark.parametrize("spec", [(None, None), ("data", None),
                                  (None, "model"), ("model", "data"),
                                  (("data", "model"), None),
                                  ((("pod", "data")), "model")])
def test_local_slice_round_trips(spec):
    """Every rank's block, put back by coordinates, is the leaf; a dim over
    several axes is split with the first axis major, as a PartitionSpec."""
    mesh = FakeMesh({"pod": 2, "data": 2, "model": 2})
    full = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    blocks = {tuple(c.values()): sh.local_slice(full, spec, mesh, c)
              for c in _coords(mesh)}
    assert torch.equal(_assemble(blocks, spec, mesh), full)
    if spec == (("data", "model"), None):
        c = {"pod": 0, "data": 1, "model": 0}
        assert torch.equal(sh.local_slice(full, spec, mesh, c), full[8:12])
    arr = full.numpy()
    for c in _coords(mesh):
        assert np.array_equal(sh.local_slice(arr, spec, mesh, c),
                              sh.local_slice(full, spec, mesh, c).numpy())


def _elastic(directory, arch, template_model, want):
    """Restore the checkpoint in ``directory`` for every rank of (4, 2)
    and of (2, 4) (ZeRO-1 specs): each rank's blocks at their shapes, put
    back together, equal ``want`` ({path: array}) bit for bit."""
    for shape in ((4, 2), (2, 4)):
        mesh = FakeMesh({"data": shape[0], "model": shape[1]})
        specs = state_shardings(template_model, mesh, zero1=True)
        blocks = {}
        for c in _coords(mesh):
            tmpl = sharded_init(template_model, 0, mesh, zero1=True,
                                coords=c)
            state, step = tckpt.restore(directory, tmpl, mesh=mesh,
                                        specs=specs, coords=c)
            assert step == 7
            for k, v in named_leaves(state):
                blocks.setdefault(k, {})[tuple(c.values())] = v
        spec_of = dict(named_leaves(specs))
        for k, by in blocks.items():
            some = next(iter(by.values()))
            if not torch.is_tensor(some):
                assert all(v == int(want[k]) for v in by.values())
                continue
            got = _assemble({c: v.detach() for c, v in by.items()},
                              spec_of[k], mesh)
            assert np.array_equal(got.numpy(), want[k]), (shape, k)
        assert sorted(blocks) == sorted(want)


def test_elastic_restore_of_a_jax_checkpoint(tmp_path):
    """granite-8b's smoke state saved by the JAX package's ckpt.save,
    restored by the port into each rank of a (4, 2) and a (2, 4) mesh."""
    jm = j_build_model(j_get_config("granite-8b", smoke=True),
                       mode="reference")
    state = j_init_state(jm, jax.random.PRNGKey(0))
    jckpt.save(state, str(tmp_path), 7)
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as saved:
        want = {k: saved[k] for k in saved.files}
    tm = build_model(get_config("granite-8b", smoke=True), device="cpu")
    _elastic(str(tmp_path), "granite-8b", tm, want)


def test_elastic_restore_of_a_port_checkpoint(tmp_path):
    """The port's own state (one process, global leaves), after a step of
    nonzero moments, the same way."""
    tm = build_model(get_config("granite-8b", smoke=True), device="cpu")
    state = init_state(tm, 0)
    gen = torch.Generator().manual_seed(1)
    for _, m in named_leaves(state["opt"]["m"]):
        m.normal_(generator=gen)
    state["opt"]["count"] = 3
    tckpt.save(state, str(tmp_path), 7)
    want = {k: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in named_leaves(state)}
    _elastic(str(tmp_path), "granite-8b", tm, want)
