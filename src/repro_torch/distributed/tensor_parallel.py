"""Tensor parallelism of the training step over a mesh's 'model' axis.

The state holds every leaf as the rank's block under the reference's
logical rules (``sharding.LOGICAL_RULES``: 'heads', 'kv_heads', 'ffn',
'vocab' and 'expert' over 'model'). :class:`TensorParallel` is what the
LM's full-sequence forward needs to compute on those blocks, Megatron's
way: the residual stream is replicated over 'model' (the same bits on
every rank), each block's attention runs the rank's heads and its MLP the
rank's FFN columns, each ending in a sum over the ranks
(``collectives.sum_from_ranks``, g); a replicated tensor that enters split
work goes through ``collectives.copy_to_ranks`` (f), whose backward sums
the ranks' partial grads. So a replicated leaf's grad is whole on every
rank (summed exactly once, where it was partial) and a split leaf's grad
is the rank's own: the step needs no reduction over 'model' of its own.

The packed q|k leaf (``wqk``, (d, (H + Hkv) * hd), and ``bqk``) is split
by the rules into contiguous blocks, which do not hold whole heads of
both kinds. Where the extent divides H and Hkv the port holds it in a
head-aligned layout (:func:`qk_permutation`): rank r's block is its q
heads then its k heads, the same block shape, a fixed permutation of the
packed dim. ``state.state_shardings`` attaches it to the leaf's spec
(``sharding.LaidOut``), so whatever cuts or gathers a state by its specs
(``state.sharded_init``, ``sharding.gather_leaf``, ``checkpoint.save``
and ``restore``) applies or undoes it, and checkpoints keep the
reference's layout. A leaf whose split does not fall on the heads the
rank computes (``wqk`` where the extent does not divide Hkv, ``wv`` at Hkv
2 over 4 ranks: the rules divide the flattened dim) is all-gathered over
'model' for each use, its grad reduce-scattered (``collectives.gather_cat``),
as GSPMD does for the reference; each such gather adds one to the ``obs``
counter "tp.gathered_leaves". Where the extent does not divide H, or the
FFN or vocab dim, those leaves are replicated by the rules and the block
runs whole on every rank, as on one device.

The recurrent blocks split by the same rules. An RG-LRU block runs the
rank's ``w / n`` channels (``proj_x``/``proj_gate`` columns, the
replicated per-channel leaves through f); its gate products take the
rank's rows of ``w_a`` and ``w_i``, so their pre-activations are partial
sums, summed in rank order and cut to the rank's channels
(``collectives.scatter_sum``), and its ``proj_out`` rows end in g. A
Mamba2 block's packed ``in_proj`` (z | x | B | C | dt) is held
head-aligned as q|k is (:func:`ssm_permutation`): rank r's block is its
z and x heads, its ``2GN / n`` of the B|C columns and its dt heads. The
B|C projection is all-gathered (every head reads its group's B and C),
the gated RMSNorm's mean square over ``d_inner`` is summed over the
ranks, and ``out_proj``'s rows end in g. Where the extent does not divide
the heads or the B|C columns the block runs whole, its split leaves
gathered and counted.

At a 'model' extent of 1 the same code runs, f, g, the gathers and the
all-to-alls returning their input, and the numbers are the single-device
step's bit for bit on the plain path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import ssm as models_ssm
from . import collectives as col
from .sharding import mesh_shape, spec_for


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """The heads one rank computes: q heads ``q0 .. q0 + hq - 1`` and, for
    its local kv slots, the global kv heads ``kv`` (the local group
    ``hq // len(kv)`` maps local q head j to slot j // group)."""
    q0: int
    hq: int
    kv: tuple
    aligned: bool          # the extent divides H and Hkv


def head_plan(h: int, hkv: int, n: int, rank: int):
    """The rank's :class:`HeadPlan` over an extent of ``n``, or None where
    ``n`` does not divide H (attention then runs whole on every rank)."""
    if h % n:
        return None
    hq, group = h // n, h // hkv
    q0 = rank * hq
    if hkv % n == 0:
        kv = tuple(range(rank * hkv // n, (rank + 1) * hkv // n))
    elif group % hq == 0:
        kv = (q0 // group,)        # the rank's q heads share one kv head
    else:
        kv = tuple(i // group for i in range(q0, q0 + hq))
    return HeadPlan(q0=q0, hq=hq, kv=kv, aligned=hkv % n == 0)


def qk_permutation(h: int, hkv: int, hd: int, n: int):
    """The head-aligned layout of the packed q|k dim over ``n`` ranks: an
    index array ``perm`` with ``aligned = reference[..., perm]``, whose
    contiguous block r is rank r's q heads then its k heads; None where
    there is nothing to permute (n 1, or n not dividing H and Hkv)."""
    if n == 1 or h % n or hkv % n:
        return None
    hq, hk = h // n, hkv // n
    cols = []
    for r in range(n):
        cols.append(np.arange(r * hq * hd, (r + 1) * hq * hd))
        cols.append(h * hd + np.arange(r * hk * hd, (r + 1) * hk * hd))
    return np.concatenate(cols)


def ssm_permutation(cfg, n: int):
    """The head-aligned layout of Mamba2's packed ``in_proj`` dim (z | x |
    B|C | dt) over ``n`` ranks: ``perm`` with ``aligned =
    reference[..., perm]``, whose contiguous block r is rank r's columns
    (``models.ssm.in_proj_segments``); None where there is nothing to
    permute (n 1, no SSM, or n not dividing the heads and 2GN)."""
    if n == 1 or not _ssm_splits(cfg, n):
        return None
    return np.concatenate([np.arange(c.start, c.stop) for r in range(n)
                           for c in models_ssm.in_proj_segments(cfg, n, r)])


def _ssm_splits(cfg, n: int) -> bool:
    """Whether ``n`` divides the config's Mamba2 heads and B|C columns."""
    if cfg.ssm is None:
        return False
    d_inner, h, conv_dim, _ = models_ssm.ssm_dims(cfg)
    return h % n == 0 and (conv_dim - d_inner) % n == 0


def param_layouts(model, mesh) -> dict:
    """{parameter path: (dim, perm)} of the leaves held in the head-aligned
    layout (the packed q|k leaves, where :func:`qk_permutation` is not
    None, and Mamba2's ``in_proj``, where :func:`ssm_permutation` is not);
    empty at a 'model' extent of 1. ``state.state_shardings`` attaches each
    to its leaf's spec."""
    cfg = model.cfg
    n = mesh_shape(mesh).get("model", 1)
    perms = {"wqk": qk_permutation(cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, n),
             "in_proj": ssm_permutation(cfg, n)}
    perms["bqk"] = perms["wqk"]
    out = {}
    for path, d in model.defs.items():
        perm = perms.get(path.rsplit("/", 1)[-1])
        if perm is None:
            continue
        dim = len(d.shape) - 1
        if spec_for(d.shape, d.axes, mesh)[dim] == "model":
            out[path] = (dim, perm)
    return out


def _select(x, dim: int, index):
    """``x``'s entries ``index`` (a range, a tuple of ranges, taken in
    turn, or a list) along ``dim``, contiguous (the GEMM kernel's operands
    are). Ranges are narrowed views, adjacent ones joined into one, so no
    index crosses to the device and a run of the whole dim is ``x``."""
    if isinstance(index, range) and index.step == 1:
        index = (index,)
    if isinstance(index, tuple):
        runs = []
        for r in index:
            if runs and runs[-1][1] == r.start:
                runs[-1][1] = r.stop
            else:
                runs.append([r.start, r.stop])
        parts = [x.narrow(dim, a, b - a) for a, b in runs]
        return (parts[0].contiguous() if len(parts) == 1
                else torch.cat(parts, dim))
    return x.index_select(dim, torch.as_tensor(list(index),
                                               device=x.device))


def _head_cols(heads, hd: int, base: int = 0) -> list:
    return [base + h * hd + c for h in heads for c in range(hd)]


class TensorParallel:
    """The forward's view of the 'model' axis of ``mesh`` for ``model``'s
    config: the group, the rank's heads (:func:`head_plan`), which dims the
    rules split, and how each leaf as held becomes the slice the rank uses
    (:meth:`take`)."""

    def __init__(self, model, mesh, axis: str = "model"):
        cfg = model.cfg
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.n = mesh_shape(mesh)[axis]
        self.group = mesh.get_group(axis)
        self.rank = mesh.get_local_rank(axis)
        self.heads = head_plan(cfg.num_heads, cfg.num_kv_heads, self.n,
                               self.rank)
        # {leaf name in its block: the dim the rules split over 'model' (of
        # the per-layer leaf, the stacks' layer axis dropped) or None}
        self._held = {}
        for path, d in model.defs.items():
            spec = spec_for(d.shape, d.axes, mesh)
            lead = 1 if d.axes and d.axes[0] == "layers" else 0
            dim = next((i - lead for i, e in enumerate(spec)
                        if e == axis), None)
            self._held["/".join(path.split("/")[-2:])] = dim
        self.ffn_split = cfg.d_ff % self.n == 0
        # the vocab-parallel lookup, head and cross entropy; at one rank the
        # plain ones (the same numbers, fewer ops)
        v = model.defs["embed"].shape[0]
        split = self.n > 1
        self.vocab_rows = (v // self.n if split
                           and self._held.get("embed") == 0 else None)
        self.head_cols = (v // self.n if split and not cfg.tie_embeddings
                          and self._held.get("lm_head") == 1 else None)
        self.ssm_groups = (_ssm_groups(cfg, self.n, self.rank)
                           if cfg.ssm is not None else None)

    # the collectives over the axis
    def f(self, x):
        return col.copy_to_ranks(x, self.group)

    def g(self, x):
        return col.sum_from_ranks(x, self.group)

    def gather(self, x, dim: int, grad: str):
        return col.gather_cat(x, dim, self.group, grad=grad)

    def scatter(self, x, dim: int):
        """The ranks' partial sums of ``x``, the rank's block along ``dim``
        (a reduce-scatter in rank order)."""
        return col.scatter_sum(x, dim, self.group)

    def held(self, key: str):
        """The dim of leaf ``key`` ("attn/wqk", "embed", ...) split over
        'model', or None."""
        return self._held.get(key)

    def take(self, leaf, key: str, dim: int, index, aligned: bool):
        """The rank's entries ``index`` (of the reference layout) along
        ``dim`` of leaf ``key`` for split work: the held block itself where
        it is exactly those (``aligned``), else the replicated leaf through
        f, or the gathered leaf (its grad reduce-scattered), then the
        entries."""
        held = self.held(key)
        if held is None:
            return _select(self.f(leaf), dim, index)
        if held == dim and aligned:
            return leaf
        obs.incr("tp.gathered_leaves")
        return _select(self.gather(leaf, held, "sum"), dim, index)

    def whole(self, leaf, key: str):
        """Leaf ``key`` whole, for work that runs whole on every rank."""
        held = self.held(key)
        if held is None:
            return leaf
        obs.incr("tp.gathered_leaves")
        return self.gather(leaf, held, "own")

    # ------------------------------------------------------------------
    # attention
    # ------------------------------------------------------------------
    def attn_params(self, p: dict, key: str = "attn") -> dict:
        """One attention layer's leaves (under ``key``: "attn", or "xattn"
        for a cross-attention layer, whose q columns project the decoder's
        stream and k, v the encoder's) as the rank uses them: its q|k
        columns, v columns and wo rows under :attr:`heads`, or every leaf
        whole where the heads do not split."""
        hp, cfg = self.heads, self.cfg
        if hp is None:
            return {k: self.whole(v, f"{key}/{k}") for k, v in p.items()}
        hd, h = cfg.head_dim, cfg.num_heads
        q = range(hp.q0 * hd, (hp.q0 + hp.hq) * hd)
        k_cols = (range(h * hd + hp.kv[0] * hd, h * hd + (hp.kv[-1] + 1) * hd)
                  if hp.aligned else _head_cols(hp.kv, hd, h * hd))
        qk = list(q) + list(k_cols)
        v_cols = (range(hp.kv[0] * hd, (hp.kv[-1] + 1) * hd) if hp.aligned
                  else _head_cols(hp.kv, hd))
        out = {}
        for name, leaf in p.items():
            last = leaf.dim() - 1
            if name in ("wqk", "bqk"):
                out[name] = self.take(leaf, f"{key}/{name}", last, qk,
                                      hp.aligned)
            elif name in ("wv", "bv"):
                out[name] = self.take(leaf, f"{key}/{name}", last, v_cols,
                                      hp.aligned)
            elif name == "wo":
                out[name] = self.take(leaf, f"{key}/wo", 0, q, True)
            else:
                raise KeyError(f"attention leaf {name!r}")
        return out

    @property
    def local_heads(self):
        """(q heads, kv heads) of the rank's attention, or None."""
        hp = self.heads
        return None if hp is None else (hp.hq, len(hp.kv))

    # ------------------------------------------------------------------
    # the MLP and the experts
    # ------------------------------------------------------------------
    def mlp_params(self, p: dict) -> dict:
        """The rank's FFN columns of w_in/w_gate and rows of w_out (the
        held blocks), or the leaves whole where F does not split."""
        if not self.ffn_split:
            return {k: self.whole(v, f"mlp/{k}") for k, v in p.items()}
        f_loc = self.cfg.d_ff // self.n
        cols = range(self.rank * f_loc, (self.rank + 1) * f_loc)
        return {k: self.take(v, f"mlp/{k}", 0 if k == "w_out" else 1, cols,
                             True) for k, v in p.items()}

    def moe_params(self, p: dict, impl: str) -> dict:
        """One MoE layer's leaves as ``impl`` runs them: "ep" the rank's
        E / n experts, "tp" each expert's F / n slice, "dense" every
        expert whole; the router whole."""
        out = {"router": p["router"]}
        e, f = self.cfg.moe.num_experts, self.cfg.d_ff
        for name in ("w_gate", "w_in", "w_out"):
            if name not in p:
                continue
            leaf, key = p[name], f"moe/{name}"
            if impl == "dense":
                out[name] = self.whole(leaf, key)
            elif impl == "ep":
                size = e // self.n
                out[name] = self.take(leaf, key, 0, range(
                    self.rank * size, (self.rank + 1) * size), True)
            else:
                size = f // self.n
                out[name] = self.take(leaf, key, 1 if name == "w_out" else 2,
                                      range(self.rank * size,
                                            (self.rank + 1) * size), True)
        return out

    # ------------------------------------------------------------------
    # the recurrent blocks
    # ------------------------------------------------------------------
    def rglru_params(self, p: dict):
        """One RG-LRU block's leaves as the rank uses them: its ``w / n``
        channels (``proj_x``/``proj_gate`` columns, ``proj_out``, ``w_a``
        and ``w_i`` rows: the held blocks; ``conv_w``, ``conv_b``, ``b_a``,
        ``b_i`` and ``lambda`` through f), or None where the rules do not
        split the width (every leaf replicated: the block runs whole)."""
        w = self.cfg.rglru.lru_width or self.cfg.d_model
        if w % self.n:
            return None
        size = w // self.n
        ch = range(self.rank * size, (self.rank + 1) * size)
        return {k: self.take(v, f"rec/{k}", 1 if k in ("proj_x", "proj_gate")
                             else 0, ch, True) for k, v in p.items()}

    def ssm_params(self, p: dict):
        """One Mamba2 block's leaves as the rank uses them: its head-aligned
        ``in_proj`` block (:func:`ssm_permutation`), its ``out_proj`` rows,
        its heads' ``a_log``, ``d_skip``, ``dt_bias`` and ``norm_scale``
        channels, and the convolution's rows of its x channels and of the
        whole B|C (through f); or None where the extent does not divide the
        heads and 2GN (the block runs whole)."""
        if self.ssm_groups is None:
            return None
        cfg, n, r = self.cfg, self.n, self.rank
        d_inner, h, conv_dim, _ = models_ssm.ssm_dims(cfg)
        blk = models_ssm.in_proj_segments(cfg, n, r)
        xs, heads = blk[0], range(r * h // n, (r + 1) * h // n)
        conv = (xs, range(d_inner, conv_dim))
        where = {"in_proj": (1, blk), "out_proj": (0, xs),
                 "conv_w": (0, conv), "conv_b": (0, conv),
                 "norm_scale": (0, xs), "a_log": (0, heads),
                 "d_skip": (0, heads), "dt_bias": (0, heads)}
        return {k: self.take(v, f"ssm/{k}", *where[k], True)
                for k, v in p.items()}


def _ssm_groups(cfg, n: int, rank: int):
    """The B|C groups the rank's heads read and their heads a group:
    (first group, groups, heads a group), or None where the extent does not
    divide the heads and 2GN. Raises where the rank's heads span a part of
    a group's heads that is not whole (a split the port does not make)."""
    if not _ssm_splits(cfg, n):
        return None
    h = models_ssm.ssm_dims(cfg)[1]
    g, hl = cfg.ssm.n_groups, h // n
    rep = h // g
    if g % n == 0:
        return (rank * g // n, g // n, rep)
    if rep % hl == 0:
        return (rank * hl // rep, 1, hl)
    raise NotImplementedError(
        f"{cfg.name}: Mamba2's {h} heads in {g} B|C groups do not split "
        f"over a 'model' extent of {n} ({hl} heads a rank across groups of "
        f"{rep})")
