"""``gemm_fused_bwd``: the backward of the fused GEMM as three launches.

* **The operand pass** (``csrc/gemm_bwd_g.cu``), bound by bytes: the
  forward epilogue transposed (:meth:`Epilogue.transpose_tile`, from the
  forward's saved preacts: silu', gelu' or relu', alone or gated) once per
  element of g, written as ``gbar`` (M, N') in bf16 (N' = 2N for the gated
  chain: g_acc | g_acc2 side by side) and as its transpose ``gbar_t`` (N',
  M); A transposed, ``a_t`` (K, M), normalised first with the forward's
  rounding point under a norm prologue (rmsnorm, or layernorm with or
  without beta, from the forward's saved statistics); for the bias chains
  fp32 dbias partials per 64-row block, summed here.
* **dA** (``csrc/gemm_bwd_da.cu``): ``dAn = gbar @ [B | B2]ᵀ`` on the
  Hopper mainloop (``csrc/gemm_sm90.cuh``); with a norm prologue, a row
  pass in the same launch applies :meth:`Prologue.transpose` at the
  forward's statistics and writes one dgamma (and for layernorm + beta one
  dbeta) partial row per 32-row block, summed here.
* **dB** (``csrc/gemm_bwd_db.cu``): ``[dB | dB2] = Anᵀ @ [gbar | gbar2]``
  on the same mainloop, read from ``a_t`` and ``gbar_t``, both outputs
  from one launch.

dresidual is g itself; the scale and the rope tables take no gradient. A
CPU tensor runs the plain versions (:func:`gemm_bwd_da_ref`,
:func:`gemm_bwd_db_ref`: the same rounding points, contractions in fp32;
:func:`gemm_bwd_g_ref` is the operand pass's); a CUDA tensor launches the
kernels or raises. The chains are those ``ops.check_chain`` and
``ops.check_backward`` accept. The
mainloop reads its operands through TMA maps, so each one is checked by
:func:`check_tma_operand` before any launch; the transposed operands' rows
are padded to a multiple of 8 elements of M (:func:`transposed_stride`).

``rstd`` everywhere is the forward's row statistics as ``ops._forward``
returns them: rstd (M,) for rmsnorm, mean and rstd as one (2, M) buffer for
layernorm; None (the CPU's forward keeps none) recomputes them from A.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.core import autotune
from repro_torch.core.autotune import pick_tile_n  # noqa: F401
from repro_torch.core.policy import gemm_policy
from .._build import CudaKernel, entry_clock, journal
from .epilogue import Epilogue
from .ops import (TILE_ROWS, TILE_WIDTHS, chain_flags,  # noqa: F401
                  kernel_saves, require, sm_count)
from .prologue import Prologue

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
G_KERNEL = CudaKernel(
    "gemm_bwd_g", "gemm_bwd_g.cu", "gemm_bwd_g_launch",
    [_P] * 15 + [_F] + [_I] * 6 + [_P])
DA_KERNEL = CudaKernel(
    "gemm_bwd_da", "gemm_bwd_da.cu", "gemm_bwd_da_launch",
    [_P] * 11 + [_I] * 6 + [_P])
DB_KERNEL = CudaKernel(
    "gemm_bwd_db", "gemm_bwd_db.cu", "gemm_bwd_db_launch",
    [_P] * 4 + [_I] * 6 + [_P])

# rows per dgamma/dbeta partial of the dA launch (NR_ROWS in
# csrc/gemm_bwd_da.cu)
ROWS_PER_PARTIAL = 32
# rows per dbias partial of the operand pass (TR in csrc/gemm_bwd_g.cu)
ROWS_PER_BIAS_PARTIAL = 64


def transposed_stride(m: int) -> int:
    """Row stride, in elements, of the operand pass's transposed outputs
    (·, M): M rounded up to 8, so every row starts 16-byte aligned."""
    return -(-m // 8) * 8


def check_tma_operand(t, name: str, col0: int = 0) -> int:
    """The address of column ``col0`` of a 2-D tensor that a TMA map will
    read row by row, after checking that the tensor is contiguous, that
    address 16-byte aligned and the row stride a multiple of 16 bytes
    (the TMA's rules); raises ValueError otherwise."""
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"gemm_fused_bwd kernel: TMA operand {name} must be "
                         f"a contiguous 2-D tensor, got shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    addr = t.data_ptr() + col0 * t.element_size()
    if addr % 16:
        raise ValueError(f"gemm_fused_bwd kernel: TMA operand {name} starts "
                         f"at an address that is not 16-byte aligned")
    if (t.stride(0) * t.element_size()) % 16:
        raise ValueError(f"gemm_fused_bwd kernel: TMA operand {name} has a "
                         f"row stride of {t.stride(0) * t.element_size()} "
                         "bytes, not a multiple of 16")
    return addr


def bwd_policies(m: int, n: int, k: int, epilogue: Epilogue,
                 prologue: Prologue, sms=None) -> tuple:
    """The (dA, dB) launches' policies of a forward (m, k) @ (k, n): the
    autotuner's ``gemm_bwd`` policies for dA's (M, K) output over N and
    dB's (K, N') output over M (with no pretuned table installed,
    ``pick_tile_n``'s width at window 8)."""
    n2 = 2 * n if epilogue.gate else n
    kw = dict(epilogue=epilogue, prologue=prologue, sms=sms)
    return (autotune.select_policy("gemm_bwd", (m, k, n), variant="da", **kw),
            autotune.select_policy("gemm_bwd", (k, n2, m), variant="db",
                                   **kw))


def check_shapes(epilogue: Epilogue, n: int, k: int) -> None:
    """Raise ValueError on shapes the kernels do not take: N and K
    multiples of 8; a rope head_dim a multiple of 16 dividing N."""
    if n % 8 or k % 8:
        raise ValueError(f"gemm_fused_bwd kernel: N ({n}) and K ({k}) must "
                         "be multiples of 8")
    if epilogue.rope:
        hd = epilogue.head_dim
        if hd % 16 or n % hd:
            raise ValueError(f"gemm_fused_bwd kernel: rope head_dim {hd} "
                             f"must be a multiple of 16 dividing N ({n})")


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


def _stats_kw(prologue: Prologue, rstd) -> dict:
    """The forward's row statistics as Prologue keyword arguments, (M, 1)
    fp32 columns: {'rstd'} for rmsnorm, {'mean', 'rstd'} for layernorm;
    {} when ``rstd`` is None (recomputed)."""
    if rstd is None:
        return {}
    f32 = torch.float32
    if prologue.norm == "layernorm":
        return {"mean": rstd[0].to(f32).reshape(-1, 1),
                "rstd": rstd[1].to(f32).reshape(-1, 1)}
    return {"rstd": rstd.to(f32).reshape(-1, 1)}


def _normed_a(a, prologue: Prologue, gamma, rstd, beta=None):
    """A in fp32 as the forward's GEMM reads it: with a norm prologue,
    normalised in fp32 (from the forward's statistics when given, else
    recomputed) and rounded to A's type."""
    f32 = torch.float32
    an = a.to(f32)
    if not prologue.is_identity:
        kw = {"gamma": gamma.to(f32).reshape(1, -1),
              **_stats_kw(prologue, rstd)}
        if prologue.beta:
            kw["beta"] = beta.to(f32).reshape(1, -1)
        an = prologue.apply(an, **kw).to(a.dtype).to(f32)
    return an


def _norm_transpose(prologue: Prologue, dan, a, gamma, rstd) -> dict:
    """:meth:`Prologue.transpose` of the recompute path (the statistics'
    own dependence on A included) on fp32 arrays, at the forward's
    statistics when given (what the dA launch's row pass reads), else
    recomputed: {'da', 'dgamma' (1, K)[, 'dbeta' (1, K)]}. With ahat the
    normalised row and dahat = dAn gamma, da = rstd (dahat - ahat
    mean_k(dahat ahat)) for rmsnorm and rstd (dahat - mean_k(dahat) - ahat
    mean_k(dahat ahat)) for layernorm."""
    gamma = gamma.to(torch.float32).reshape(1, -1)
    if rstd is None:
        return prologue.transpose(dan, a, gamma=gamma)
    st = _stats_kw(prologue, rstd)
    ln = prologue.norm == "layernorm"
    ahat = ((a - st["mean"]) if ln else a) * st["rstd"]
    dahat = dan * gamma
    out = dahat
    if ln:
        out = out - torch.mean(dahat, dim=-1, keepdim=True)
    out = out - ahat * torch.mean(dahat * ahat, dim=-1, keepdim=True)
    tr = {"da": st["rstd"] * out,
          "dgamma": torch.sum(dan * ahat, dim=0, keepdim=True)}
    if prologue.beta:
        tr["dbeta"] = torch.sum(dan, dim=0, keepdim=True)
    return tr


def gemm_bwd_g_ref(a, g, *, epilogue: Epilogue, prologue: Prologue,
                   bias=None, scale=None, sin=None, cos=None, gamma=None,
                   beta=None, rstd=None, preacts=()) -> dict:
    """Plain version of the operand pass, in fp32 holding the kernel's
    bf16 values: 'gbar' (M, N'), 'gbar_t' (N', M), 'a_t' (K, M) and
    'dbias_part' (ceil(M / 64), N), the g_bias sum of each 64-row block,
    or None without a bias."""
    st = g_streams_ref(epilogue, g, preacts, bias=bias, scale=scale,
                       sin=sin, cos=cos)
    gbar = (torch.cat([st["g_acc"], st["g_acc2"]], dim=1) if epilogue.gate
            else st["g_acc"])
    part = None
    if epilogue.bias:
        part = torch.stack([blk.sum(dim=0) for blk in
                            st["g_bias"].split(ROWS_PER_BIAS_PARTIAL)])
    return {"gbar": gbar, "gbar_t": gbar.T.contiguous(),
            "a_t": _normed_a(a, prologue, gamma, rstd, beta).T.contiguous(),
            "dbias_part": part}


def gemm_bwd_da_ref(a, b, g, *, epilogue: Epilogue, prologue: Prologue,
                    b2=None, bias=None, scale=None, sin=None, cos=None,
                    gamma=None, beta=None, rstd=None, preacts=()) -> tuple:
    """Plain version of the dA launch: (da in A's type, dgamma (K,) fp32 or
    None, dbeta (K,) fp32 or None). ``beta`` is not read: dbeta is the
    column sum of dAn."""
    del beta
    f32 = torch.float32
    st = g_streams_ref(epilogue, g, preacts, bias=bias, scale=scale,
                       sin=sin, cos=cos)
    dan = st["g_acc"] @ b.to(f32).T
    if epilogue.gate:
        dan = dan + st["g_acc2"] @ b2.to(f32).T
    if prologue.is_identity:
        return dan.to(a.dtype), None, None
    tr = _norm_transpose(prologue, dan, a.to(f32), gamma, rstd)
    dbeta = tr["dbeta"].reshape(-1) if "dbeta" in tr else None
    return tr["da"].to(a.dtype), tr["dgamma"].reshape(-1), dbeta


def gemm_bwd_db_ref(a, b, g, *, epilogue: Epilogue, prologue: Prologue,
                    b2=None, bias=None, scale=None, sin=None, cos=None,
                    gamma=None, beta=None, rstd=None, preacts=()) -> tuple:
    """Plain version of the dB launch: (db, db2 or None, dbias (N,) fp32 or
    None); A is normalised with the forward's rounding point, from ``rstd``
    when given (else recomputed)."""
    st = g_streams_ref(epilogue, g, preacts, bias=bias, scale=scale,
                       sin=sin, cos=cos)
    an = _normed_a(a, prologue, gamma, rstd, beta)
    db = (an.T @ st["g_acc"]).to(b.dtype)
    db2 = (an.T @ st["g_acc2"]).to(b2.dtype) if epilogue.gate else None
    dbias = st["g_bias"].sum(dim=0) if epilogue.bias else None
    return db, db2, dbias


def gemm_fused_bwd(a, b, g, *, epilogue: Epilogue, prologue: Prologue,
                   b2=None, bias=None, scale=None, sin=None, cos=None,
                   gamma=None, beta=None, rstd=None, preacts=()) -> tuple:
    """The backward of ``gemm_fused``: ``(da, db, grads)`` with ``grads``
    keyed by operand name (b2, bias, residual, gamma, beta). ``rstd`` is
    the forward's row statistics and ``preacts`` its saved raw accumulators
    (``ops.kernel_saves``). Journals its three launches as ``obs`` ops
    "gemm_bwd_g" (the operand pass, which the reference has no event for),
    "gemm_bwd_da" and "gemm_bwd_db"."""
    g = g.contiguous()
    kw = dict(epilogue=epilogue, prologue=prologue, b2=b2, bias=bias,
              scale=scale, sin=sin, cos=cos, gamma=gamma, beta=beta,
              rstd=rstd, preacts=preacts)
    dev = a.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gemm_fused_bwd: unsupported device {dev}")
    m, k = a.shape
    n = b.shape[1]
    chain = (f"{prologue.describe()}|{epilogue.describe()}"
             if obs.enabled() else None)
    # the operand pass, dA and dB, each journaled as it ends; the CPU runs
    # the plain versions of dA and dB (the operand pass's is inside them)
    pol_da = pol_db = None
    if dev.type == "cuda" or obs.enabled():
        pol_da, pol_db = bwd_policies(
            m, n, k, epilogue, prologue,
            sm_count(dev) if dev.type == "cuda" else None)
    t0 = entry_clock()
    if dev.type == "cuda":
        run = BwdLaunch(a, b, g, da_policy=pol_da, db_policy=pol_db, **kw)
        run.operand_pass()
    if obs.enabled():
        journal("gemm_bwd_g", dev, t0, variant="g", chain=chain)
    t0 = entry_clock()
    if dev.type == "cuda":
        da, dgamma, dbeta = run.da()
    else:
        da, dgamma, dbeta = gemm_bwd_da_ref(a, b, g, **kw)
    if obs.enabled():
        journal("gemm_bwd_da", dev, t0, variant="da", chain=chain,
                flops=2 * m * n * k, policy=pol_da)
    t0 = entry_clock()
    if dev.type == "cuda":
        (db, db2), dbias = run.db(), run.dbias()
    else:
        db, db2, dbias = gemm_bwd_db_ref(a, b, g, **kw)
    if obs.enabled():
        journal("gemm_bwd_db", dev, t0, variant="db", chain=chain,
                flops=(2 if epilogue.gate else 1) * 2 * m * n * k,
                policy=pol_db)
    grads = {"residual": g}
    for name, grad in (("b2", db2), ("bias", dbias), ("gamma", dgamma),
                       ("beta", dbeta)):
        if grad is not None:
            grads[name] = grad
    return da, db, grads


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

class BwdLaunch:
    """The three launches of one ``gemm_fused_bwd`` on the card. The
    constructor checks every operand (the TMA operands of both GEMMs
    included) and allocates the operand pass's buffers and the outputs, so
    nothing is launched for a call the kernels would refuse; the methods
    launch the operand pass, dA (``passes``: 1 the GEMM, 2 the norm row
    pass, 3 both) and dB, in that order. ``da_policy``/``db_policy``: the
    products' policies (tile width and window; None: :func:`bwd_policies`);
    ``tile_n`` fixes the tile width of both at window 8 (the smoke's
    sweeps)."""

    def __init__(self, a, b, g, *, epilogue, prologue, b2=None, bias=None,
                 scale=None, sin=None, cos=None, gamma=None, beta=None,
                 rstd=None, preacts=(), tile_n=0, da_policy=None,
                 db_policy=None):
        m, k = a.shape
        n = b.shape[1]
        dev, bf16, f32 = a.device, torch.bfloat16, torch.float32
        check_shapes(epilogue, n, k)
        if len(preacts) != kernel_saves(epilogue):
            raise ValueError(f"gemm_fused_bwd kernel: chain "
                             f"{epilogue.describe()!r} needs "
                             f"{kernel_saves(epilogue)} saved preacts, got "
                             f"{len(preacts)}")
        if tile_n not in (0, *TILE_WIDTHS):
            raise ValueError(f"gemm_fused_bwd kernel: tile_n {tile_n} not in "
                             f"{(0, *TILE_WIDTHS)}")
        self.m, self.n, self.k = m, n, k
        self.epilogue, self.device = epilogue, dev
        self.norm = not prologue.is_identity
        self.scale = _scale_value(epilogue, scale)
        self.g_side = [require(g, "g", (m, n), bf16, dev)]
        for i in range(2):
            self.g_side.append(
                require(preacts[i], f"preact{i + 1}", (m, n), bf16, dev)
                if i < len(preacts) else None)
        if epilogue.rope:
            hd = epilogue.head_dim
            self.g_side += [require(sin, "sin", (m, hd), f32, dev),
                            require(cos, "cos", (m, hd), f32, dev)]
        else:
            self.g_side += [None, None]
        # an activation's input holds the bias: its transpose reads it
        self.g_side.append(
            require(bias, "bias", (n,), bf16, dev)
            if epilogue.bias and epilogue.activation != "none" else None)
        self.a = require(a, "a", (m, k), bf16, dev)
        self.gamma = self.beta = self.mean = self.rstd = None
        if self.norm:
            self.gamma = require(gamma, "gamma", (k,), bf16, dev)
            if prologue.beta:
                self.beta = require(beta, "beta", (k,), bf16, dev)
            if prologue.norm == "layernorm":
                # one (2, M) buffer: the mean's row, then rstd's
                self.mean = require(rstd, "stats", (2, m), f32, dev)
                self.rstd = self.mean + 4 * m
            else:
                self.rstd = require(rstd, "rstd", (m,), f32, dev)
        self.b = require(b, "b", (k, n), bf16, dev)
        self.b2 = (require(b2, "b2", (k, n), bf16, dev) if epilogue.gate
                   else None)

        n2 = 2 * n if epilogue.gate else n
        # dA's output is (M, K), dB's (K, N')
        if tile_n:
            da_policy = db_policy = gemm_policy(tile_n, op="gemm_bwd")
        if da_policy is None or db_policy is None:
            auto = bwd_policies(m, n, k, epilogue, prologue, sm_count(dev))
            da_policy, db_policy = da_policy or auto[0], db_policy or auto[1]
        for pol in (da_policy, db_policy):
            if pol.block_n not in TILE_WIDTHS or pol.splits != 1 \
                    or pol.window < 1:
                raise ValueError(f"gemm_fused_bwd kernel: policy "
                                 f"{pol.describe()} is not a backward plan")
        self.tile_da, self.window_da = da_policy.block_n, da_policy.window
        self.tile_db, self.window_db = db_policy.block_n, db_policy.window
        self.ld_t = transposed_stride(m)
        self.gbar = torch.empty((m, n2), dtype=bf16, device=dev)
        self.gbar_t = torch.empty((n2, self.ld_t), dtype=bf16, device=dev)
        self.a_t = torch.empty((k, self.ld_t), dtype=bf16, device=dev)
        self.dbias_part = (torch.empty((-(-m // ROWS_PER_BIAS_PARTIAL), n),
                                       dtype=f32, device=dev)
                           if epilogue.bias else None)
        self.da_out = torch.empty((m, k), dtype=bf16, device=dev)
        self.dan = self.dgamma_part = self.dbeta_part = None
        if self.norm:
            parts = -(-m // ROWS_PER_PARTIAL)
            self.dan = torch.empty((m, k), dtype=f32, device=dev)
            self.dgamma_part = torch.empty((parts, k), dtype=f32, device=dev)
            if prologue.beta:
                self.dbeta_part = torch.empty((parts, k), dtype=f32,
                                              device=dev)
        self.db_out = torch.empty((k, n), dtype=bf16, device=dev)
        self.db2_out = (torch.empty((k, n), dtype=bf16, device=dev)
                        if epilogue.gate else None)
        # the mainloop's operands, checked before any launch
        tma = [(self.gbar, "gbar", 0), (b, "b", 0), (self.gbar_t, "gbar_t", 0),
               (self.a_t, "a_t", 0)]
        if epilogue.gate:
            tma += [(self.gbar, "gbar2", n), (b2, "b2", 0)]
        for t, name, col0 in tma:
            check_tma_operand(t, name, col0)

    @staticmethod
    def _ptr(t):
        return None if t is None else t.data_ptr()

    def operand_pass(self) -> None:
        fn = G_KERNEL.fn()
        stream = G_KERNEL.stream(self.device)
        G_KERNEL.launches += 1
        code = fn(*self.g_side, self.a, self.gamma, self.beta, self.mean,
                  self.rstd, self.gbar.data_ptr(), self.gbar_t.data_ptr(),
                  self.a_t.data_ptr(), self._ptr(self.dbias_part),
                  self.scale, self.m, self.n, self.k, self.ld_t,
                  chain_flags(self.epilogue), self.epilogue.head_dim, stream)
        G_KERNEL.check(code)

    def da(self, passes: int = 3, kernel: CudaKernel = DA_KERNEL) -> tuple:
        """(da (M, K) bf16, dgamma (K,) fp32 or None, dbeta (K,) fp32 or
        None). ``kernel``: another build of the same entry point."""
        fn = kernel.fn()
        stream = kernel.stream(self.device)
        kernel.launches += 1
        code = fn(self.gbar.data_ptr(), self.b, self.b2,
                  self.a if self.norm else None, self.gamma, self.mean,
                  self.rstd, self._ptr(self.dan), self.da_out.data_ptr(),
                  self._ptr(self.dgamma_part), self._ptr(self.dbeta_part),
                  self.m, self.n, self.k, self.tile_da, self.window_da, passes,
                  stream)
        kernel.check(code)
        return (self.da_out, self._sum(self.dgamma_part),
                self._sum(self.dbeta_part))

    def db(self, kernel: CudaKernel = DB_KERNEL) -> tuple:
        """(db (K, N) bf16, db2 (K, N) bf16 or None); ``kernel`` as in
        :meth:`da`."""
        fn = kernel.fn()
        stream = kernel.stream(self.device)
        kernel.launches += 1
        code = fn(self.a_t.data_ptr(), self.gbar_t.data_ptr(),
                  self.db_out.data_ptr(), self._ptr(self.db2_out), self.m,
                  self.ld_t, self.n, self.k, self.tile_db, self.window_db,
                  stream)
        kernel.check(code)
        return self.db_out, self.db2_out

    def dbias(self):
        """dbias (N,) fp32 from the operand pass's partials, or None."""
        return self._sum(self.dbias_part)

    @staticmethod
    def _sum(part):
        return None if part is None else part.sum(dim=0)
