"""``gemm_fused_bwd``: the backward of the fused GEMM as two kernels.

* **dA** (``csrc/gemm_bwd_da.cu``): ``dAn = gbar @ Bᵀ [+ gbar2 @ B2ᵀ]``,
  where ``gbar`` is the forward epilogue transposed and run as a prologue on
  each g tile (:meth:`Epilogue.transpose_tile`, from the forward's saved
  preacts); with the rmsnorm prologue, a row pass in the same launch applies
  :meth:`Prologue.transpose` and writes one dgamma partial row per 32-row
  block, summed here.
* **dB** (``csrc/gemm_bwd_db.cu``): ``dB [, dB2] = Anᵀ @ gbar [, gbar2]``,
  the norm recomputed on the A tiles with the forward's rounding point, both
  outputs of the SwiGLU up-projection from one launch, the dbias column sum
  folded into the store.

dresidual is g itself; the scale and the rope tables take no gradient. A
CPU tensor runs
the kernels' plain versions (:func:`gemm_bwd_da_ref`,
:func:`gemm_bwd_db_ref`: the same rounding points, contractions in fp32); a
CUDA tensor launches the kernels or raises. The chains are those
``ops.check_chain`` accepts.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel
from .epilogue import Epilogue
from .ops import chain_flags, kernel_saves, require
from .prologue import Prologue

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DA_KERNEL = CudaKernel(
    "gemm_bwd_da", "gemm_bwd_da.cu", "gemm_bwd_da_launch",
    [_P] * 13 + [_F] + [_I] * 5 + [_P])
DB_KERNEL = CudaKernel(
    "gemm_bwd_db", "gemm_bwd_db.cu", "gemm_bwd_db_launch",
    [_P] * 11 + [_F] + [_I] * 5 + [_P])

# rows per dgamma partial of the dA launch (NR_ROWS in csrc/gemm_bwd_da.cu)
ROWS_PER_PARTIAL = 32


def _scale_value(epilogue: Epilogue, scale) -> float:
    return float(scale) if epilogue.scale else 1.0


def g_streams_ref(epilogue: Epilogue, g, preacts=(), *, bias=None,
                  scale=None, sin=None, cos=None) -> dict:
    """The kernels' g tiles as full arrays: :meth:`Epilogue.transpose_tile`
    in fp32, with 'g_acc'/'g_acc2' rounded to g's type (the tensor cores'
    operand; the reference contracts them in fp32) and 'g_bias' kept fp32."""
    f32 = torch.float32
    p = [None if x is None else x.to(f32) for x in (*preacts, None, None)][:2]
    kw = {}
    if epilogue.bias:
        kw["bias"] = bias.to(f32).reshape(1, -1)
    if epilogue.scale:
        kw["scale"] = _scale_value(epilogue, scale)
    if epilogue.rope:
        kw["sin"], kw["cos"] = sin.to(f32), cos.to(f32)
    streams = epilogue.transpose_tile(g.to(f32), p[0], p[1], **kw)
    return {k: v if k == "g_bias" else v.to(g.dtype).to(f32)
            for k, v in streams.items()}


def gemm_bwd_da_ref(a, b, g, *, epilogue: Epilogue, prologue: Prologue,
                    b2=None, bias=None, scale=None, sin=None, cos=None,
                    gamma=None, preacts=()) -> tuple:
    """Plain version of the dA launch: (da in A's type, dgamma (K,) fp32 or
    None)."""
    f32 = torch.float32
    st = g_streams_ref(epilogue, g, preacts, bias=bias, scale=scale,
                       sin=sin, cos=cos)
    dan = st["g_acc"] @ b.to(f32).T
    if epilogue.gate:
        dan = dan + st["g_acc2"] @ b2.to(f32).T
    if prologue.is_identity:
        return dan.to(a.dtype), None
    tr = prologue.transpose(dan, a.to(f32),
                            gamma=gamma.to(f32).reshape(1, -1))
    return tr["da"].to(a.dtype), tr["dgamma"].reshape(-1)


def gemm_bwd_db_ref(a, b, g, *, epilogue: Epilogue, prologue: Prologue,
                    b2=None, bias=None, scale=None, sin=None, cos=None,
                    gamma=None, rstd=None, preacts=()) -> tuple:
    """Plain version of the dB launch: (db, db2 or None, dbias (N,) fp32 or
    None); A is normalised with the forward's rounding point, from ``rstd``
    when given (else recomputed)."""
    f32 = torch.float32
    st = g_streams_ref(epilogue, g, preacts, bias=bias, scale=scale,
                       sin=sin, cos=cos)
    an = a.to(f32)
    if not prologue.is_identity:
        kw = {"gamma": gamma.to(f32).reshape(1, -1)}
        if rstd is not None:
            kw["rstd"] = rstd.to(f32).reshape(-1, 1)
        an = prologue.apply(an, **kw).to(a.dtype).to(f32)
    db = (an.T @ st["g_acc"]).to(b.dtype)
    db2 = (an.T @ st["g_acc2"]).to(b2.dtype) if epilogue.gate else None
    dbias = st["g_bias"].sum(dim=0) if epilogue.bias else None
    return db, db2, dbias


def gemm_fused_bwd(a, b, g, *, epilogue: Epilogue, prologue: Prologue,
                   b2=None, bias=None, scale=None, sin=None, cos=None,
                   gamma=None, rstd=None, preacts=()) -> tuple:
    """The backward of ``gemm_fused``: ``(da, db, grads)`` with ``grads``
    keyed by operand name (b2, bias, residual, gamma). ``rstd`` is the
    forward's row statistics and ``preacts`` its saved raw accumulators
    (``ops.kernel_saves``)."""
    g = g.contiguous()
    kw = dict(epilogue=epilogue, prologue=prologue, b2=b2, bias=bias,
              scale=scale, sin=sin, cos=cos, gamma=gamma, preacts=preacts)
    if a.device.type == "cpu":
        da, dgamma = gemm_bwd_da_ref(a, b, g, **kw)
        db, db2, dbias = gemm_bwd_db_ref(a, b, g, rstd=rstd, **kw)
    elif a.device.type == "cuda":
        da, dgamma = _launch_da(a, b, g, rstd=rstd, **kw)
        db, db2, dbias = _launch_db(a, b, g, rstd=rstd, **kw)
    else:
        raise ValueError(f"gemm_fused_bwd: unsupported device {a.device}")
    grads = {"residual": g}
    if db2 is not None:
        grads["b2"] = db2
    if dbias is not None:
        grads["bias"] = dbias
    if dgamma is not None:
        grads["gamma"] = dgamma
    return da, db, grads


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

def _g_pointers(a, g, epilogue, preacts, sin, cos) -> tuple:
    """Checked pointers of the g-side operands: (g, preact, preact2, sin,
    cos), None where the chain has none."""
    m, n = g.shape
    dev, bf16 = a.device, torch.bfloat16
    if n % 8 or a.shape[1] % 8:
        raise ValueError(f"gemm_fused_bwd kernel: N ({n}) and K "
                         f"({a.shape[1]}) must be multiples of 8")
    if len(preacts) != kernel_saves(epilogue):
        raise ValueError(f"gemm_fused_bwd kernel: chain "
                         f"{epilogue.describe()!r} needs "
                         f"{kernel_saves(epilogue)} saved preacts, got "
                         f"{len(preacts)}")
    ptrs = [require(g, "g", (m, n), bf16, dev)]
    for i in range(2):
        ptrs.append(require(preacts[i], f"preact{i + 1}", (m, n), bf16, dev)
                    if i < len(preacts) else None)
    if epilogue.rope:
        hd = epilogue.head_dim
        if hd % 16 or n % hd:
            raise ValueError(f"gemm_fused_bwd kernel: rope head_dim {hd} "
                             f"must be a multiple of 16 dividing N ({n})")
        ptrs.append(require(sin, "sin", (m, hd), torch.float32, dev))
        ptrs.append(require(cos, "cos", (m, hd), torch.float32, dev))
    else:
        ptrs += [None, None]
    return tuple(ptrs)


def _launch_da(a, b, g, *, epilogue, prologue, b2, bias, scale, sin, cos,
               gamma, rstd, preacts):
    del bias   # no chain the kernel takes reads it in the transpose
    m, k = a.shape
    n = b.shape[1]
    dev, bf16 = a.device, torch.bfloat16
    gp = _g_pointers(a, g, epilogue, preacts, sin, cos)
    bp = require(b, "b", (k, n), bf16, dev)
    b2p = require(b2, "b2", (k, n), bf16, dev) if epilogue.gate else None
    da = torch.empty((m, k), dtype=bf16, device=dev)
    dan = dgamma_part = None
    ap = gammap = rstdp = None
    if not prologue.is_identity:
        ap = require(a, "a", (m, k), bf16, dev)
        gammap = require(gamma, "gamma", (k,), bf16, dev)
        rstdp = require(rstd, "rstd", (m,), torch.float32, dev)
        dan = torch.empty((m, k), dtype=torch.float32, device=dev)
        dgamma_part = torch.empty(
            (-(-m // ROWS_PER_PARTIAL), k), dtype=torch.float32, device=dev)
    fn = DA_KERNEL.fn()
    stream = DA_KERNEL.stream(dev)
    DA_KERNEL.launches += 1
    code = fn(*gp, bp, b2p, ap, gammap, rstdp,
              None if dan is None else dan.data_ptr(), da.data_ptr(),
              None if dgamma_part is None else dgamma_part.data_ptr(),
              _scale_value(epilogue, scale), m, n, k, chain_flags(epilogue),
              epilogue.head_dim, stream)
    DA_KERNEL.check(code)
    return da, None if dgamma_part is None else dgamma_part.sum(dim=0)


def _launch_db(a, b, g, *, epilogue, prologue, b2, bias, scale, sin, cos,
               gamma, rstd, preacts):
    del bias
    m, k = a.shape
    n = b.shape[1]
    dev, bf16 = a.device, torch.bfloat16
    gp = _g_pointers(a, g, epilogue, preacts, sin, cos)
    ap = require(a, "a", (m, k), bf16, dev)
    gammap = rstdp = None
    if not prologue.is_identity:
        gammap = require(gamma, "gamma", (k,), bf16, dev)
        rstdp = require(rstd, "rstd", (m,), torch.float32, dev)
    db = torch.empty((k, n), dtype=bf16, device=dev)
    db2 = (torch.empty((k, n), dtype=bf16, device=dev)
           if epilogue.gate else None)
    dbias = (torch.empty((n,), dtype=torch.float32, device=dev)
             if epilogue.bias else None)
    fn = DB_KERNEL.fn()
    stream = DB_KERNEL.stream(dev)
    DB_KERNEL.launches += 1
    code = fn(*gp, ap, gammap, rstdp, db.data_ptr(),
              None if db2 is None else db2.data_ptr(),
              None if dbias is None else dbias.data_ptr(),
              _scale_value(epilogue, scale), m, n, k, chain_flags(epilogue),
              epilogue.head_dim, stream)
    DB_KERNEL.check(code)
    return db, db2, dbias
