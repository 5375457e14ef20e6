"""Logical-axis -> mesh sharding rules (divisibility-aware), and placement.

The reference's rules (MaxText-style), as pure logic over a mesh's axis
names and sizes:

  batch      -> ('pod', 'data')     data parallel (hierarchical across pods)
  vocab      -> 'model'             embedding/LM-head sharding
  heads      -> 'model'             TP over attention heads (dim = H*hd)
  kv_heads   -> 'model'
  ffn        -> 'model'             TP over the MLP hidden dim
  expert     -> 'model'             EP (the MoE expert dim)
  embed      -> None                activations replicated over 'model'
  layers     -> None                the stacked layer axis

A mesh axis is dropped for a tensor dim that it does not divide (whisper's
vocab 51865 on a 16-way model axis): the dim is replicated, and the
fallback is reported. A spec is a tuple with one entry per dim: None, an
axis name, or a tuple of axis names (the ``PartitionSpec`` analogue). Every
function takes a torch ``DeviceMesh`` or any object with ``axis_names`` and
a ``shape`` mapping (the reference tests' ``FakeMesh``).

Placement is the port's counterpart of ``jax.device_put`` with a
``NamedSharding``: each rank holds plain local tensors, as the body of a
``shard_map`` sees them. :func:`local_slice` cuts a rank's block out of a
full leaf; :func:`gather_leaf` rebuilds the full leaf from the ranks'
blocks with all-gathers over the mesh's dim groups. The spec of a leaf
held in another layout than the reference's (the tensor-parallel step's
head-aligned q|k: ``state.state_shardings`` builds it from
``tensor_parallel.param_layouts``) is a :class:`LaidOut`, which carries
its layout (dim, perm): the leaf is permuted before it is cut and
un-permuted after it is gathered, so a gathered leaf is always in the
reference's layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

_COLLECTIVES = ("none", "all_to_all", "all_gather", "reduce_scatter",
                "all_reduce")


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``) or of a mesh-like object with ``axis_names`` and a ``shape``
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_names(mesh) -> tuple:
    return tuple(mesh_shape(mesh))


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """What one sharded launch knows of its sharding: the participating
    mesh axes ``((axis_name, size), ...)``, which logical operand dim is
    split over which axis ``((operand_dim, axis_name), ...)``, and the
    collective the chain pays on the wire (none | all_to_all | all_gather
    | reduce_scatter | all_reduce). Frozen and hashable, as the
    reference's."""

    mesh: tuple = ()
    partition: tuple = ()
    collective: str = "none"

    def __post_init__(self):
        if self.collective not in _COLLECTIVES:
            raise ValueError(f"unknown collective {self.collective!r} "
                             f"(one of {_COLLECTIVES})")
        names = set()
        for entry in self.mesh:
            name, size = entry
            if not isinstance(name, str) or int(size) < 1:
                raise ValueError(f"bad mesh entry {entry!r}")
            names.add(name)
        for entry in self.partition:
            dim, axis = entry
            if axis is not None and axis not in names:
                raise ValueError(
                    f"partition {entry!r} names axis {axis!r} not in mesh "
                    f"{self.mesh!r}")

    @property
    def n_shards(self) -> int:
        return math.prod(int(size) for _, size in self.mesh) if self.mesh \
            else 1

    def axis_size(self, name: str) -> int:
        for axis, size in self.mesh:
            if axis == name:
                return int(size)
        raise KeyError(name)

    def describe(self) -> str:
        """A stable compact token of the spec."""
        mesh = ",".join(f"{a}={s}" for a, s in self.mesh)
        part = ",".join(f"{d}@{a}" for d, a in self.partition)
        return f"{mesh}|{part}|{self.collective}"

    @classmethod
    def for_axis(cls, mesh, axis: str, *, dim: str,
                 collective: str) -> "ShardSpec":
        """A one-axis spec from a live mesh."""
        return cls(mesh=((axis, mesh_shape(mesh)[axis]),),
                   partition=((dim, axis),), collective=collective)


def train_shard_spec(cfg, mesh, *, model_axis: str = "model"
                     ) -> Optional[ShardSpec]:
    """The ShardSpec of a training step's model-parallel extent, None where
    there is none: EP (all_to_all) where the experts divide the axis, TP
    (all_reduce) otherwise; a dense model prices the Megatron MLP's
    all_reduce."""
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    if sizes.get(model_axis, 1) == 1:
        return None
    moe = getattr(cfg, "moe", None)
    if (moe is not None and getattr(moe, "shard", "expert") == "expert"
            and moe.num_experts % sizes[model_axis] == 0):
        return ShardSpec.for_axis(mesh, model_axis, dim="expert",
                                  collective="all_to_all")
    return ShardSpec.for_axis(mesh, model_axis, dim="ffn",
                              collective="all_reduce")


LOGICAL_RULES: dict = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "expert": ("model",),
    "embed": (),
    "layers": (),
    None: (),
}


def mesh_axes_for(logical: Optional[str], mesh) -> tuple:
    names = axis_names(mesh)
    return tuple(a for a in LOGICAL_RULES.get(logical, ()) if a in names)


def spec_for(shape: tuple, logical_axes: tuple, mesh, *,
             report: Optional[list] = None) -> tuple:
    """The spec of one leaf. A dim whose axes do not divide it is
    replicated and, with ``report``, appended there as (shape, logical,
    dim, axes' size)."""
    sizes = mesh_shape(mesh)
    parts = []
    for dim, logical in zip(shape, logical_axes):
        axes = mesh_axes_for(logical, mesh)
        size = math.prod(sizes[a] for a in axes) if axes else 1
        if axes and dim % size == 0:
            parts.append(axes if len(axes) > 1 else axes[0])
        else:
            if axes and report is not None:
                report.append((tuple(shape), logical, dim, size))
            parts.append(None)
    return tuple(parts)


def tree_map2(fn, a, b):
    """fn over the leaves of two nested dicts of the same keys, in sorted
    key order (a pytree's order, so fallback reports list as the
    reference's)."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


def _map1(fn, a):
    if isinstance(a, dict):
        return {k: _map1(fn, v) for k, v in a.items()}
    return fn(a)


def shardings_for_tree(axes_tree, shape_tree, mesh, *,
                       report: Optional[list] = None):
    """axes_tree: a nested dict of logical-axes tuples; shape_tree: the
    matching tensors (or anything with ``shape``). Returns the tree of
    specs."""
    return tree_map2(lambda axes, arr: spec_for(tuple(arr.shape), axes,
                                                mesh, report=report),
                     axes_tree, shape_tree)


def divisible_axes(dim: int, mesh, axes) -> Optional[tuple]:
    """The one divisibility rule of batch-like dims: the given mesh axes
    iff they all exist on the mesh and their product divides ``dim``; None
    otherwise (the caller replicates)."""
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    axes = tuple(a for a in axes if a in names)
    if not axes:
        return None
    size = math.prod(sizes[a] for a in axes)
    return axes if dim % size == 0 else None


def leaf_nbytes(arr) -> int:
    """Byte size of a leaf with ``shape`` and ``dtype`` (a torch dtype, or
    anything numpy names)."""
    dtype = arr.dtype
    item = (dtype.itemsize if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).itemsize)
    return int(math.prod(arr.shape)) * item


def batch_specs(batch_tree, mesh) -> dict:
    """Dim 0 (the global batch) over ('pod', 'data'), the rest replicated;
    replicated where the batch is smaller than the data-parallel degree.
    One axis is named alone, as a ``PartitionSpec`` holds it."""
    def one(arr):
        axes = divisible_axes(arr.shape[0], mesh, ("pod", "data"))
        rest = (None,) * (len(arr.shape) - 1)
        if not axes:
            return (None,) + rest
        return (axes if len(axes) > 1 else axes[0],) + rest
    return _map1(one, batch_tree)


def data_axis_names(mesh) -> tuple:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _uses(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def _shard_free_dim(spec, shape, mesh, axis: str = "data"):
    """``spec`` with ``axis`` added on the largest unsharded dim it divides
    (and is no larger than), or None: no such dim, or the axis already in
    use by another dim."""
    size = mesh_shape(mesh)[axis]
    spec = list(spec) + [None] * (len(shape) - len(spec))
    if any(_uses(s, axis) for s in spec):
        return None
    candidates = [(shape[i], i) for i in range(len(shape))
                  if spec[i] is None and shape[i] % size == 0
                  and shape[i] >= size]
    if not candidates:
        return None
    _, dim = max(candidates)
    spec[dim] = axis
    return tuple(spec)


def zero1_shardings(param_specs, shape_tree, mesh):
    """ZeRO-1: the optimizer moments also sharded over 'data', on the
    largest unsharded divisible dim of each param (not only dim 0, so
    stacked MoE tensors such as (24, 128, 5120, 8192) shard too)."""
    if "data" not in axis_names(mesh):
        return param_specs

    def one(spec, arr):
        out = _shard_free_dim(spec, tuple(arr.shape), mesh)
        return out if out is not None else spec
    return tree_map2(one, param_specs, shape_tree)


def fsdp_shardings(param_specs, shape_tree, mesh, min_bytes: int = 2**20):
    """FSDP/ZeRO-3: the parameters themselves sharded over 'data' (leaves
    under ``min_bytes`` stay as they are)."""
    if "data" not in axis_names(mesh):
        return param_specs

    def one(spec, arr):
        if leaf_nbytes(arr) < min_bytes:
            return spec
        out = _shard_free_dim(spec, tuple(arr.shape), mesh)
        return out if out is not None else spec
    return tree_map2(one, param_specs, shape_tree)


def cache_specs(cache_tree, mesh, *, stacked: bool) -> dict:
    """KV and state caches: the batch dim over ('pod', 'data') and, for an
    attention KV leaf ((L?), B, Hkv, S, hd), the sequence dim over 'model'
    (a sequence-parallel cache). ``stacked``: a leading layers dim."""
    daxes = data_axis_names(mesh)
    sizes = mesh_shape(mesh)
    lead = 1 if stacked else 0

    def one(arr):
        nd = len(arr.shape)
        spec = [None] * nd
        bdim = lead if nd > lead else 0
        baxes = divisible_axes(arr.shape[bdim], mesh, daxes)
        if baxes:
            spec[bdim] = baxes if len(baxes) > 1 else baxes[0]
        if nd == 4 + lead and "model" in sizes:
            sdim = nd - 2
            if arr.shape[sdim] % sizes["model"] == 0:
                spec[sdim] = "model"
        return tuple(spec)
    return _map1(one, cache_tree)


# ---------------------------------------------------------------------------
# Placement: a rank's block of a leaf, and the leaf from the blocks
# ---------------------------------------------------------------------------

def mesh_coords(mesh) -> dict:
    """{axis name: this rank's coordinate} on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_index(entry, mesh, coords: dict) -> tuple:
    """(index, count) of a rank's block along a dim of spec ``entry``:
    a dim over several axes is split over their product, the first axis
    major (the ``PartitionSpec`` order)."""
    sizes = mesh_shape(mesh)
    index, count = 0, 1
    for a in _entry_axes(entry):
        index = index * sizes[a] + coords[a]
        count *= sizes[a]
    return index, count


class LaidOut(tuple):
    """A leaf's spec (a tuple, equal to the plain spec) that also carries
    ``layout`` (dim, perm): the rank holds its block of the leaf permuted
    by ``perm`` along ``dim``."""

    def __new__(cls, spec, layout):
        out = super().__new__(cls, spec)
        out.layout = layout
        return out

    def __reduce__(self):
        return LaidOut, (tuple(self), self.layout)


def layout_of(spec):
    """The (dim, perm) a :class:`LaidOut` spec carries, or None."""
    return getattr(spec, "layout", None)


def permute_dim(x, dim: int, perm, *, inverse: bool = False):
    """``x`` (a tensor or a numpy array) with ``perm`` applied along
    ``dim`` (``inverse``: undone)."""
    if inverse:
        perm = np.argsort(perm)
    if torch.is_tensor(x):
        return x.index_select(dim, torch.as_tensor(perm, device=x.device))
    return np.take(x, perm, axis=dim)


def local_slice(full, spec, mesh, coords: Optional[dict] = None):
    """The block of ``full`` (a tensor or a numpy array) that the rank at
    ``coords`` (default: this rank's, on a ``DeviceMesh``) holds under
    ``spec``: a view (of the permuted leaf, where ``spec`` carries a
    layout)."""
    coords = mesh_coords(mesh) if coords is None else coords
    if layout_of(spec) is not None:
        full = permute_dim(full, *layout_of(spec))
    index = []
    for dim, entry in enumerate(spec):
        i, count = block_index(entry, mesh, coords)
        size = full.shape[dim] // count
        index.append(slice(i * size, (i + 1) * size))
    return full[tuple(index)]


def local_tree(tree, specs, mesh, coords: Optional[dict] = None):
    """:func:`local_slice` over a nested dict; a non-tensor leaf (an int)
    is kept as it is."""
    return tree_map2(lambda x, s: local_slice(x, s, mesh, coords)
                 if torch.is_tensor(x) else x, tree, specs)


def gather_leaf(local, spec, mesh):
    """The full leaf from every rank's block under ``spec``: per sharded
    dim, all-gathers over the dim's mesh axes, the last axis first (so a
    dim over ('pod', 'data') is gathered over 'data', then 'pod'), then
    the layout ``spec`` carries undone. Every rank of the mesh must call
    it. A replicated spec returns ``local``."""
    import torch.distributed as dist

    out = local
    for dim, entry in enumerate(spec):
        for axis in reversed(_entry_axes(entry)):
            group = mesh.get_group(axis)
            parts = [torch.empty_like(out) for _ in
                     range(dist.get_world_size(group))]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts, dim=dim)
    if layout_of(spec) is not None:
        out = permute_dim(out, *layout_of(spec), inverse=True)
    return out


def gather_tree(tree, specs, mesh):
    return tree_map2(lambda x, s: gather_leaf(x, s, mesh)
                 if torch.is_tensor(x) else x, tree, specs)
