"""Train state: {"params", "opt", "step"[, "ef"]}, the reference's layout.

The parameters are fp32 masters (``cfg.param_dtype``) that require grad;
the forward casts them to the compute type. With ``grad_compress`` the
state also holds ``"ef"``, the error-feedback residuals (fp32 zeros shaped
like the params).

Over a mesh each rank holds its local blocks of the state: the leaves'
specs come from the logical sharding rules (:func:`state_shardings`), the
moments with ZeRO-1 sliced over 'data' as well. :func:`sharded_init`
builds a rank's blocks. The error-feedback residuals are sliced as the
trainer's reduced grads are, over 'data' on each leaf's ZeRO-1 dim, with
or without ``zero1`` (the reference keeps them as the params are; the
quantisation scale is each whole leaf's either way, so the numbers are the
same). Over a 'model' extent that divides the heads the packed q|k leaves
(and their moments and residuals) are held in the tensor-parallel step's
head-aligned layout: their specs are ``sharding.LaidOut``, so whatever
cuts or gathers a state by :func:`state_shardings` (``sharded_init``,
``checkpoint.save``/``restore``) keeps the reference's layout on disk.
"""
from __future__ import annotations

import torch

from repro_torch.device import dtype_of
from repro_torch.distributed.sharding import (LaidOut, axis_names,
                                              block_index, fsdp_shardings,
                                              local_tree, mesh_coords,
                                              shardings_for_tree, tree_map2,
                                              zero1_shardings)
from repro_torch.distributed.tensor_parallel import param_layouts
from repro_torch.models.common import nest, tree_map
from repro_torch.optim import adamw_init, ef_init
from repro_torch.optim.optimizer import named_leaves


def init_state(model, seed: int = 0, params=None, *,
               grad_compress: bool = False) -> dict:
    """Fresh state from ``model.init(seed)`` in the param type, or from a
    copy of ``params`` (a tree of tensors) when given."""
    if params is None:
        params = model.init(seed, dtype=model.cfg.param_dtype)
    else:
        params = tree_map(lambda t: t.detach().to(model.device).clone(),
                          params)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    state = {"params": params, "opt": adamw_init(params), "step": 0}
    if grad_compress:
        state["ef"] = ef_init(params)
    return state


def abstract_params(model) -> dict:
    """The params' shapes and types as meta tensors (no memory)."""
    return nest({path: torch.empty(d.shape, dtype=dtype_of(d.dtype),
                                   device="meta")
                 for path, d in model.defs.items()})


def state_shardings(model, mesh, *, zero1: bool = True, fsdp: bool = False,
                    grad_compress: bool = False, report=None) -> dict:
    """The spec of every state leaf: the params' by the logical rules
    (with ``fsdp`` also over 'data'), the moments' with ``zero1`` also over
    'data' on each leaf's largest free dim, the error-feedback residuals'
    so sliced in any case, the ints' replicated (()). A leaf held in the
    head-aligned layout (``tensor_parallel.param_layouts``) has a
    ``LaidOut`` spec carrying it, in the params, the moments and the
    residuals alike."""
    shapes = abstract_params(model)
    p_sh = shardings_for_tree(model.axes(), shapes, mesh, report=report)
    if fsdp:
        p_sh = fsdp_shardings(p_sh, shapes, mesh)
    sliced = zero1_shardings(p_sh, shapes, mesh)
    layouts = param_layouts(model, mesh)
    if layouts:
        p_sh, sliced = (nest({k: LaidOut(s, layouts[k]) if k in layouts
                              else s for k, s in named_leaves(tree)})
                        for tree in (p_sh, sliced))
    moments = sliced if zero1 else p_sh
    sh = {"params": p_sh, "opt": {"m": moments, "v": moments, "count": ()},
          "step": ()}
    if grad_compress:
        sh["ef"] = sliced
    return sh


def local_shape(shape, spec, mesh) -> tuple:
    """A leaf's block shape under ``spec``."""
    zero = {a: 0 for a in axis_names(mesh)}
    return tuple(n // block_index(e, mesh, zero)[1]
                 for n, e in zip(shape, spec))


def sharded_init(model, seed: int, mesh, *, zero1: bool = True,
                 grad_compress: bool = False, params=None,
                 coords: dict | None = None) -> dict:
    """This rank's blocks of :func:`init_state`'s state under
    :func:`state_shardings`: the params drawn whole (every rank draws the
    same from ``seed``) and cut to the rank's block (a copy only where
    the block is smaller than the leaf, or permuted), the moments and
    residuals made at their block's shape."""
    sh = state_shardings(model, mesh, zero1=zero1,
                         grad_compress=grad_compress)
    coords = mesh_coords(mesh) if coords is None else coords
    full = init_state(model, seed, params)["params"]
    local = local_tree(full, sh["params"], mesh, coords)

    def own(block, whole):
        block = block.detach()
        if block.shape != whole.shape:
            block = block.clone()
        return block.requires_grad_(True)
    params = tree_map2(own, local, full)
    shapes = abstract_params(model)

    def zeros(spec, arr):
        return torch.zeros(local_shape(arr.shape, spec, mesh),
                           dtype=torch.float32, device=model.device)
    state = {"params": params,
             "opt": {"m": tree_map2(zeros, sh["opt"]["m"], shapes),
                     "v": tree_map2(zeros, sh["opt"]["v"], shapes),
                     "count": 0},
             "step": 0}
    if grad_compress:
        state["ef"] = tree_map2(zeros, sh["ef"], shapes)
    return state

