"""Parameter declaration machinery and the shared numerics.

A model is described by a flat dict ``{path: ParamDef}``; the nested param
tree is derived from the flat paths, with the same keys and shapes as the
reference package, so its parameters convert one to one
(``models.convert.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from repro_torch import obs
from repro_torch.device import dtype_of
from repro_torch.kernels.gemm import Epilogue, gemm_fused, norm_prologue


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple              # logical axis names, one per dim (the sharding
                             # rules' input, distributed/sharding.py)
    init: str = "normal"     # 'normal' | 'zeros' | 'ones' | 'lru_a'
    scale: float = 1.0       # stddev multiplier (normal init)
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def nest(flat: Mapping[str, object]) -> dict:
    """{'a/b/c': v} -> {'a': {'b': {'c': v}}}"""
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def logical_axes(defs: Mapping[str, ParamDef]) -> dict:
    """The nested tree of each parameter's logical axes."""
    return nest({p: d.axes for p, d in defs.items()})


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(defs: Mapping[str, ParamDef], generator: torch.Generator,
                device, cast=None) -> dict:
    """The reference's distributions, drawn from a torch generator: zeros,
    ones, the RG-LRU's Λ ('lru_a': sigmoid(Λ) uniform in [0.9, 0.999]), or
    a normal with std = scale / sqrt(fan_in), where fan_in is the leading
    dim of a matrix (for a stacked (layers, d, f) weight that is the layer
    count, as in the reference) and the length of a vector, scaled in
    place. With ``cast`` each leaf is cast to that type as soon as it is
    drawn, so at most one leaf exists in its param type at a time (the same
    numbers as casting the whole tree after). The numbers differ from the reference's
    (another generator); the tests feed both sides the same numpy weights
    instead."""
    flat = {}
    for path, d in sorted(defs.items()):
        dtype = dtype_of(d.dtype)
        if d.init == "zeros":
            flat[path] = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            flat[path] = torch.ones(d.shape, dtype=dtype, device=device)
        elif d.init == "lru_a":
            u = torch.empty(d.shape, dtype=torch.float32, device=device)
            u.uniform_(0.9, 0.999, generator=generator)
            flat[path] = torch.log(u / (1 - u)).to(dtype)
        elif d.init == "normal":
            fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
            std = d.scale / math.sqrt(max(1, fan_in))
            flat[path] = torch.randn(d.shape, generator=generator,
                                     dtype=torch.float32,
                                     device=device).mul_(std).to(dtype)
        else:
            raise ValueError(f"unknown init {d.init!r} for {path}")
        if cast is not None:
            flat[path] = flat[path].to(cast)
    return nest(flat)


def cast_params(params, dtype):
    """Floating leaves cast to the compute type (training keeps fp32 masters
    and casts inside the differentiated forward, so autograd carries the
    cast's backward and hands fp32 grads to the optimizer). A leaf already
    in ``dtype`` is returned as it is, without a copy."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def cross_entropy_loss(logits, labels, mask=None, *, tp=None):
    """Mean cross entropy over the valid positions, in fp32. With ``tp``
    (a ``TensorParallel`` whose rank holds ``logits``' vocab columns
    ``rank * V_loc ..``) it is the vocab-parallel form (:func:`nll_terms`)."""
    nll = nll_terms(logits, labels, tp=tp)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def nll_terms(logits, labels, *, tp=None):
    """Each position's lse - gold logit in fp32. With ``tp`` the logits
    are the rank's vocab columns: the log-sum-exp of the ranks' local
    log-sum-exps (gathered; at one rank the local one bit for bit) and the
    gold logit from the rank that holds it (summed, g)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if tp is None:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return lse - gold
    size = logits.shape[-1]
    local = labels.long() - tp.rank * size
    mine = (local >= 0) & (local < size)
    gold = torch.gather(logits, -1, local.clamp(0, size - 1)[..., None])
    gold = tp.g(torch.where(mine, gold[..., 0], 0.0))
    lse = torch.logsumexp(tp.gather(lse[None], 0, "own"), dim=0)
    return lse - gold


# ---------------------------------------------------------------------------
# Shared numerics (fp32 internally)
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6, reduce=None):
    """RMSNorm over the last dim; ``reduce``, where given, maps the mean
    square before its use (a tensor-parallel rank's sum over the ranks
    that hold the rest of the dim)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if reduce is not None:
        var = reduce(var)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    c = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(c * c, dim=-1, keepdim=True)
    out = c * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def apply_norm(cfg, x, p, prefix: str):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p[f"{prefix}_scale"])
    return layernorm(x, p[f"{prefix}_scale"], p.get(f"{prefix}_bias"))


def norm_params(p, prefix: str) -> tuple:
    """The (scale, bias) pair of a norm, for the ``prenorm`` argument: the
    kernel mode folds the norm into the next GEMM's prologue."""
    return (p[f"{prefix}_scale"], p.get(f"{prefix}_bias"))


def apply_prenorm(cfg, x, prenorm: tuple):
    """The standalone norm of a ``prenorm`` pair (reference mode, or a
    path whose GEMM takes no norm prologue); counted as the ``obs`` counter
    "model.standalone_norm", as the reference counts it."""
    obs.incr("model.standalone_norm")
    scale, bias = prenorm
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, scale)
    return layernorm(x, scale, bias)


def act_fn(name: str):
    if name in ("swiglu", "silu"):
        return torch.nn.functional.silu
    if name in ("geglu", "gelu"):
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(name)


def norm_prologue_kw(cfg, prenorm) -> dict:
    """gemm_fused keyword arguments folding a block's pre-norm (rmsnorm, or
    layernorm with its bias as the beta row) into the GEMM prologue."""
    scale, bias = prenorm
    kw = {"prologue": norm_prologue(cfg.norm, beta=bias is not None),
          "gamma": scale}
    if bias is not None:
        kw["beta"] = bias
    return kw


def resolve_norm_prologue(cfg, prenorm, *, kind: str, plan_shape, dtype,
                          residual: bool = True) -> bool:
    """The first rung of the reference's prenorm ladder, shared by the MLP
    and the QKV projections: whether the block's pre-norm folds into the
    first GEMM's prologue, by ``select_fusion(kind, plan_shape,
    prenorm=cfg.norm)``. (The reference also asks for a VMEM-legal
    prologue policy; the port's row pass fits any width.)"""
    from repro_torch.core import autotune

    if prenorm is None:
        return False
    plan = autotune.select_fusion(kind, plan_shape, dtype, residual=residual,
                                  prenorm=cfg.norm)
    return plan["plan"] == "fused"


# Config activation name -> epilogue activation name, as the reference's:
# an activation act_fn does not know must not fuse as something else.
_EPILOGUE_ACT = {"swiglu": "silu", "silu": "silu",
                 "geglu": "gelu", "gelu": "gelu"}


def _mlp_up_fused(cfg, p, x2, prenorm):
    """The fused up-projection of (tokens, d) ``x2``: the block's pre-norm
    in its prologue, one dual-output GEMM whose store is act(x @ w_gate) *
    (x @ w_in) for a gated MLP, else one GEMM storing act(x @ w_in)."""
    if cfg.mlp_act not in _EPILOGUE_ACT:
        raise ValueError(cfg.mlp_act)
    act = _EPILOGUE_ACT[cfg.mlp_act]
    kw = norm_prologue_kw(cfg, prenorm) if prenorm is not None else {}
    if cfg.mlp_act in ("swiglu", "geglu"):
        return gemm_fused(x2, p["w_gate"], b2=p["w_in"],
                          epilogue=Epilogue(activation=act, gate=True),
                          out_dtype=x2.dtype, **kw)
    return gemm_fused(x2, p["w_in"], epilogue=Epilogue(activation=act),
                      out_dtype=x2.dtype, **kw)


def _mlp_fused(cfg, p, x, *, residual, residual_scale, prenorm):
    """The kernel-mode MLP: the block's pre-norm folds into the up GEMM's
    prologue; a gated MLP (swiglu, geglu) runs its two up-projections as one
    dual-output GEMM whose store is act(x @ w_gate) * (x @ w_in), a plain
    one (gelu) one GEMM whose store is act(x @ w_in); the down GEMM's store
    adds the scaled residual."""
    *lead, d = x.shape
    tokens = math.prod(lead)
    h = _mlp_up_fused(cfg, p, x.reshape(tokens, d), prenorm)
    if residual is None:
        y = gemm_fused(h, p["w_out"], out_dtype=x.dtype)
    else:
        y = gemm_fused(h, p["w_out"],
                       epilogue=Epilogue(residual=True, scale=True),
                       residual=residual.reshape(tokens, d),
                       scale=residual_scale, out_dtype=x.dtype)
    return y.reshape(x.shape)


def _mlp_auto(cfg, p, x, *, residual, residual_scale, prenorm):
    """The reference's ``_mlp_fused`` decisions: the norm folded where the
    prenorm chain wins, else the norm standalone and the rest fused where
    the plain chain's fused plan wins, else None (the plain chain)."""
    from repro_torch.core import autotune

    *lead, d = x.shape
    shape = (math.prod(lead), d, p["w_in"].shape[-1],
             int(cfg.mlp_act in ("swiglu", "geglu")))
    has_res = residual is not None
    kw = dict(residual=residual, residual_scale=residual_scale)
    if resolve_norm_prologue(cfg, prenorm, kind="mlp", plan_shape=shape,
                             dtype=x.dtype, residual=has_res):
        return _mlp_fused(cfg, p, x, prenorm=prenorm, **kw)
    if autotune.select_fusion("mlp", shape, x.dtype,
                              residual=has_res)["plan"] != "fused":
        return None
    if prenorm is not None:
        x = apply_prenorm(cfg, x, prenorm)
    return _mlp_fused(cfg, p, x, prenorm=None, **kw)


def mlp_forward(cfg, p, x, *, mode: str = "reference", residual=None,
                residual_scale: float = 1.0, prenorm=None,
                auto: bool = False):
    """Gated (swiglu/geglu) or plain (gelu) MLP over p = {w_in, w_gate,
    w_out} (no w_gate for the plain one).

    With ``residual`` the result is ``residual + residual_scale * mlp(x)``;
    with ``prenorm`` (the block's norm params) ``x`` is the pre-norm stream
    and the MLP reads ``norm(x)``. 'kernel' mode runs the fused chain (with
    ``auto``, the model's ``qkv_plan="auto"``, the plan ``select_fusion``
    picks: the norm folded, the norm standalone and the rest fused, or the
    plain chain); 'reference' the unfused plain one.
    """
    if mode == "kernel":
        if not auto:
            return _mlp_fused(cfg, p, x, residual=residual,
                              residual_scale=residual_scale, prenorm=prenorm)
        out = _mlp_auto(cfg, p, x, residual=residual,
                        residual_scale=residual_scale, prenorm=prenorm)
        if out is not None:
            return out
    if prenorm is not None:
        x = apply_prenorm(cfg, x, prenorm)
    act = act_fn(cfg.mlp_act)
    if cfg.mlp_act in ("swiglu", "geglu"):
        h = act(x @ p["w_gate"]) * (x @ p["w_in"])
    else:
        h = act(x @ p["w_in"])
    m = h @ p["w_out"]
    if residual is None:
        return m
    return residual + residual_scale * m


def split_mlp_forward(cfg, p, x, *, tp, mode: str, residual,
                      residual_scale: float = 1.0, prenorm=None,
                      auto: bool = False):
    """``mlp_forward`` with the residual on a tensor-parallel rank (``tp``):
    the rank's FFN columns of the up-projection and rows of the down, the
    ranks' partial products summed (g), then the scaled residual added
    once. In 'kernel' mode the replicated stream and the norm's scale and
    bias enter the up GEMM's prologue through f, and the partials are the
    down GEMM's fp32 accumulators (``out_dtype=torch.float32``, one
    contraction split), summed in fp32 before the residual; the plain path
    norms the replicated stream, then f, and sums its partials in fp32
    rounded to the compute type, as its one-device product rounds. Where
    the rules do not split F the MLP runs whole on every rank (``auto`` as
    :func:`mlp_forward`'s)."""
    p = tp.mlp_params(p)
    if not tp.ffn_split:
        return mlp_forward(cfg, p, x, mode=mode, residual=residual,
                           residual_scale=residual_scale, prenorm=prenorm,
                           auto=auto)
    *lead, d = x.shape
    if mode == "kernel":
        if prenorm is not None:
            prenorm = tuple(None if t is None else tp.f(t) for t in prenorm)
        h = _mlp_up_fused(cfg, p, tp.f(x).reshape(math.prod(lead), d),
                          prenorm)
        part = gemm_fused(h, p["w_out"], out_dtype=torch.float32)
        y = tp.g(part) * residual_scale + residual.reshape(part.shape).float()
        return y.to(x.dtype).reshape(x.shape)
    if prenorm is not None:
        x = apply_prenorm(cfg, x, prenorm)
    m = tp.g(mlp_forward(cfg, p, tp.f(x), mode=mode))
    return residual + residual_scale * m


def mlp_defs(cfg, prefix: str, *, stack: int | None = None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    dt = cfg.param_dtype
    defs = {f"{prefix}/w_in": ParamDef(lead + (d, f), lx + ("embed", "ffn"),
                                       dtype=dt),
            f"{prefix}/w_out": ParamDef(lead + (f, d), lx + ("ffn", "embed"),
                                        dtype=dt)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        defs[f"{prefix}/w_gate"] = ParamDef(lead + (d, f),
                                            lx + ("embed", "ffn"), dtype=dt)
    return defs


def norm_defs(cfg, prefix: str, *, stack: int | None = None) -> dict:
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    dt = cfg.param_dtype
    defs = {f"{prefix}_scale": ParamDef(lead + (cfg.d_model,), lx + (None,),
                                        init="ones", dtype=dt)}
    if cfg.norm == "layernorm":
        defs[f"{prefix}_bias"] = ParamDef(lead + (cfg.d_model,), lx + (None,),
                                          init="zeros", dtype=dt)
    return defs
