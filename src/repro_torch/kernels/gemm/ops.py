"""``gemm_fused``: the fused GEMM op.

A CPU tensor runs the plain version (:func:`gemm_fused_ref`); a CUDA tensor
launches the hand-written kernel (``csrc/gemm_fused.cu``) or raises. The
chains the kernel takes are checked on both devices, so a call the CPU
accepts is one the card accepts too:

* prologue ``none``, ``rmsnorm`` or ``layernorm`` with or without the
  ``beta`` row (a row pass in the launch writes the row statistics and the
  normalised A); not precomputed statistics;
* epilogue stages scalar ``scale``, ``bias``, ``rope``, an activation
  (``silu``, ``gelu`` or ``relu``) alone or with ``gate`` (the
  dual-output SwiGLU/GeGLU up-projection) and ``residual``; not row or
  column scales, nor fp8 operands.

On the card every operand is bf16 (sin/cos fp32), contiguous and 16-byte
aligned, with N and K multiples of 8. The kernel's tile width, the split of
its contraction and its walk's window come from a ``KernelPolicy``: the
caller's (``policy=``) or the one ``repro_torch.core.autotune`` resolves for
the shape, the chain and the SM count (with no pretuned table installed
:func:`plan_gemm`'s plan at window 8), so a call gives the same bits every
time and a row's result does not depend on the other rows. The window
changes only the order of the tiles, never a bit of the output.

Under autograd the op is a ``torch.autograd.Function``. ``bwd_mode`` picks
its backward (``"auto"``: ``core.autotune.select_bwd_mode`` routes the call
by the byte models): ``"kernel"`` (the default, see :func:`default_bwd_mode`) runs
the chain transpose as the two backward kernels (``backward.py``); the
forward then also stores the raw accumulators the transpose needs and keeps
the row statistics. The backward kernels take every chain the forward
kernel takes (the rmsnorm and layernorm prologues, silu, gelu and relu
alone or gated); :func:`check_backward` names what they still refuse.
``"reference"`` is autograd through
:func:`gemm_fused_ref`, the oracle, for every chain; it runs only when the
caller asks for it. The scale is a Python number (``residual_scale``) and
takes no gradient: unlike the reference, no fp32 preactivation is kept for
a dscale.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core import autotune
from repro_torch.core.grid_swizzle import DEFAULT_WINDOW
from .._build import CudaKernel, entry_clock, journal
from .epilogue import EPILOGUE_NONE, Epilogue
from .prologue import PROLOGUE_NONE, Prologue
from .ref import gemm_fused_ref, norm_rows_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "gemm_fused", "gemm_fused.cu", "gemm_fused_launch",
    [_P] * 16 + [_F, _F] + [_I] * 8 + [_P])

BWD_MODES = ("kernel", "reference", "auto")
_DEFAULT_BWD_MODE = ["kernel"]


@contextlib.contextmanager
def default_bwd_mode(mode: str):
    """Temporarily set the backward of ``gemm_fused`` calls that pass no
    ``bwd_mode`` (every model layer): how the parity checks pit the kernel
    backward against the oracle on the same graph."""
    if mode not in BWD_MODES:
        raise ValueError(f"unknown bwd_mode {mode!r}; have {BWD_MODES}")
    prev = _DEFAULT_BWD_MODE[0]
    _DEFAULT_BWD_MODE[0] = mode
    try:
        yield
    finally:
        _DEFAULT_BWD_MODE[0] = prev


def kernel_saves(epilogue: Epilogue) -> int:
    """Raw accumulators the forward stores for the kernel backward: the
    activation's input (and the gate's second product). The reference also
    stores them for a scale chain, for dscale; the port's scale takes no
    gradient."""
    return epilogue.n_accumulators if epilogue.activation != "none" else 0

# bit flags of the C entry point (csrc/gemm_fused.cu), and the activation's
# code in the bits from _EP_ACT_SHIFT on
_EP_SCALE, _EP_BIAS, _EP_ROPE, _EP_GATE, _EP_RESIDUAL = 1, 2, 4, 8, 16
_EP_ACT_SHIFT = 5
ACT_CODES = {"none": 0, "silu": 1, "gelu": 2, "relu": 3}
# fp8 operands: the reference upcasts them in its kernel; this one refuses
_FP8 = tuple(getattr(torch, n) for n in ("float8_e4m3fn", "float8_e5m2")
             if hasattr(torch, n))
# a rope head_dim must divide this width: every tile the kernel takes for
# a rope chain is a multiple of it, so tiles hold whole heads
BLOCK_N = 128

# The Hopper mainloop's geometry and the forward's hand-fitted plan live in
# the policy layer (repro_torch.core.autotune), whose analytic ranking they
# are; they are named here for the kernel's callers.
from repro_torch.core.autotune import (  # noqa: E402,F401
    COLUMN_COST, MIN_SPLIT_STAGES, TILE_DEPTH, TILE_ROWS, TILE_WIDTHS,
    TILES_PER_SM, plan_gemm, split_count, tile_count, tile_widths)


def staged(epilogue: Epilogue, splits: int) -> bool:
    """Whether the kernel hands its accumulators to the reduce pass through
    an fp32 workspace: a split contraction, or a rope head_dim under 16,
    whose partner columns another thread holds."""
    return splits > 1 or (epilogue.rope and epilogue.head_dim % 16 != 0)


def raw_width(n: int, tile_n: int, gate: bool) -> int:
    """Columns of the kernel's raw accumulator for an N-wide output: N, or
    for the gated chain whole tiles of B's and B2's columns side by side."""
    return -(-n // (tile_n // 2)) * tile_n if gate else n


_SM_COUNT = {}


def sm_count(device) -> int:
    if device.index not in _SM_COUNT:
        _SM_COUNT[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device.index]


def _check_operands(epilogue, prologue, provided, pro_provided):
    for chain, wanted, given in ((epilogue, epilogue.operand_names(), provided),
                                 (prologue, prologue.operand_names(),
                                  pro_provided)):
        for name, val in given.items():
            if (val is not None) != (name in wanted):
                raise ValueError(
                    f"gemm_fused: operand {name!r} "
                    f"{'missing for' if name in wanted else 'not accepted by'}"
                    f" {type(chain).__name__.lower()} {chain.describe()!r}")


def rope_store_fits(head_dim: int) -> bool:
    """Whether the kernel's store can rotate heads of ``head_dim``: a
    multiple of 4 dividing BLOCK_N, so every tile holds whole heads. The
    QKV ladder's rung 1 takes rung 2 where this is False, as the
    reference's does where its rope-store plan does not fit."""
    return head_dim > 0 and BLOCK_N % head_dim == 0 and head_dim % 4 == 0


def check_chain(epilogue: Epilogue, prologue: Prologue) -> None:
    """Raise on a chain the CUDA kernel does not take."""
    if prologue.precomputed_stats:
        raise NotImplementedError(
            f"gemm_fused kernel: prologue {prologue.describe()!r} is not "
            "supported (statistics computed in the launch only)")
    if epilogue.scale_kind != "scalar":
        raise NotImplementedError(
            "gemm_fused kernel: per-row/per-column scales are not supported")
    if epilogue.rope and not rope_store_fits(epilogue.head_dim):
        raise NotImplementedError(
            f"gemm_fused kernel: rope head_dim {epilogue.head_dim} must be a "
            f"multiple of 4 dividing the kernel's block width {BLOCK_N}")


def check_backward(epilogue: Epilogue, prologue: Prologue) -> None:
    """Raise on a chain whose backward the kernels do not take, each with
    its own message: the precomputed-statistics prologue (its dmean and
    drstd), and row or column scales (their dscale). Every other chain the
    forward kernel takes, they take: both norms (layernorm with or without
    beta), silu', gelu' and relu' alone or gated."""
    if prologue.precomputed_stats:
        raise NotImplementedError(
            f"gemm_fused backward kernel: prologue {prologue.describe()!r} "
            "is not supported (the dmean/drstd of precomputed statistics); "
            "pass bwd_mode='reference'")
    if epilogue.scale and epilogue.scale_kind != "scalar":
        raise NotImplementedError(
            f"gemm_fused backward kernel: {epilogue.scale_kind} scales are "
            "not supported (their dscale); pass bwd_mode='reference'")


@dataclasses.dataclass(frozen=True)
class _Spec:
    """The non-tensor arguments of one differentiated call."""
    epilogue: Epilogue
    prologue: Prologue
    scale: object
    out_dtype: torch.dtype
    bwd_mode: str
    policy: object = None


# the tensor operands of the autograd Function, in its argument order
_GRAD_OPERANDS = ("b2", "bias", "residual", "gamma", "beta", "sin", "cos")


def gemm_fused(a, b, *, epilogue: Epilogue = EPILOGUE_NONE,
               prologue: Prologue = PROLOGUE_NONE, b2=None, bias=None,
               residual=None, scale=None, sin=None, cos=None,
               gamma=None, beta=None, mean=None, rstd=None,
               out_dtype=torch.bfloat16, bwd_mode: str | None = None,
               policy=None):
    """C = epilogue(prologue(A) @ B [, A @ B2]) in one launch on the card.

    a (M, K), b and b2 (K, N); gamma and beta (K,); bias (N,); residual
    (M, N);
    scale a scalar; sin/cos (M, head_dim) fp32 duplicated-halves tables.
    ``out_dtype`` float32 is the chainless product's raw fp32 accumulators
    (one contraction split; a row-parallel product's partial sum, summed
    over the ranks before it is rounded). ``bwd_mode`` ("kernel" |
    "reference" | "auto"; None: :func:`default_bwd_mode`) picks the
    backward when autograd records the call. ``policy``: the launch's
    ``KernelPolicy`` (tile width, split, window); None resolves it
    (:func:`launch_policy`). The launch is journaled as ``obs`` op
    "gemm_fused" with its policy (:func:`_forward`).
    """
    provided = dict(b2=b2, bias=bias, residual=residual, scale=scale,
                    sin=sin, cos=cos)
    pro_provided = dict(gamma=gamma, beta=beta, mean=mean, rstd=rstd)
    _check_operands(epilogue, prologue, provided, pro_provided)
    check_chain(epilogue, prologue)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_fused: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not multiply")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gemm_fused: unsupported device {a.device}")
    if any(t is not None and t.dtype in _FP8 for t in (a, b, b2)):
        raise NotImplementedError("gemm_fused kernel: fp8 operands are not "
                                  "supported (bf16 on the card)")
    if bwd_mode is None:
        bwd_mode = _DEFAULT_BWD_MODE[0]
    if bwd_mode not in BWD_MODES:
        raise ValueError(f"unknown bwd_mode {bwd_mode!r}; have {BWD_MODES}")
    operands = (a, b, b2, bias, residual, gamma, beta, sin, cos)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        if any(torch.is_tensor(t) and t.requires_grad
               for t in (scale, sin, cos)):
            raise NotImplementedError(
                "gemm_fused: the scale and the rope tables take no gradient")
        if bwd_mode == "auto":
            bwd_mode = auto_bwd_mode(a, b, epilogue, prologue)
        if bwd_mode == "kernel":
            check_backward(epilogue, prologue)
        return _GemmFusedFn.apply(*operands, _Spec(
            epilogue, prologue, scale, out_dtype, bwd_mode, policy))
    return _forward(a, b, epilogue, prologue, b2=b2, bias=bias,
                    residual=residual, scale=scale, sin=sin, cos=cos,
                    gamma=gamma, beta=beta, out_dtype=out_dtype,
                    bwd_mode=bwd_mode, policy=policy)[0]


def auto_bwd_mode(a, b, epilogue: Epilogue, prologue: Prologue) -> str:
    """``bwd_mode="auto"``: ``core.autotune.select_bwd_mode``'s route, the
    oracle for a chain whose backward the kernels refuse."""
    mode = autotune.select_bwd_mode(a.shape[0], b.shape[1], a.shape[1],
                                    dtype=a.dtype, epilogue=epilogue,
                                    prologue=prologue)
    if mode == "kernel":
        try:
            check_backward(epilogue, prologue)
        except NotImplementedError:
            return "reference"
    return mode


def launch_policy(a, b, epilogue: Epilogue, prologue: Prologue,
                  policy=None):
    """The policy of one forward launch: ``policy``, else the autotuner's
    for the shape, the chain and the card's SM count."""
    if policy is not None:
        return policy
    return autotune.select_policy(
        "gemm", (a.shape[0], b.shape[1], a.shape[1]), a.dtype,
        epilogue=epilogue, prologue=prologue,
        sms=sm_count(a.device) if a.is_cuda else None)


class _OpRan(threading.local):
    """Whether an implementation of the custom op (the plain one or the
    kernel's) ran on this thread since :func:`_forward` cleared it: what
    ``_forward`` journals by."""
    ran = False


_OP_RAN = _OpRan()


def _forward(a, b, epilogue, prologue, *, b2, bias, residual, scale, sin,
             cos, gamma, out_dtype, beta=None, save_preact=False,
             bwd_mode="kernel", policy=None):
    """(out, stats, preacts) through the custom op ``repro_torch::gemm_fused``:
    the kernel on the card, the plain version on the CPU. ``stats`` is the
    kernel's row statistics in fp32: rstd (M,) for rmsnorm, (2, M) mean and
    rstd for layernorm (None without a prologue, and on the CPU, where the
    plain backward recomputes them); ``preacts`` the raw accumulators
    rounded to A's type when ``save_preact`` (:func:`kernel_saves` of them),
    else (). The op is what a selective-checkpoint policy sees of the
    launch (``models.lm._remat``'s "dots"). ``policy`` is resolved here
    (:func:`launch_policy`) on the card, or on the CPU for the journal.

    Journaled as ``obs`` op "gemm_fused" (variant ``bwd_mode``) when the
    op ran: not when a selective checkpoint's recompute hands back the
    outputs it kept, nor under fake tensors. The event is recorded here,
    before autograd saves anything, since a checkpoint's recompute stops
    at the last tensor it needs to save."""
    if epilogue.scale_kind != "scalar" or prologue.precomputed_stats:
        raise NotImplementedError("gemm_fused kernel: row/col scales and "
                                  "precomputed statistics are not supported")
    t0, _OP_RAN.ran = entry_clock(), False
    if a.is_cuda or obs.enabled():
        policy = launch_policy(a, b, epilogue, prologue, policy)
    plan = None if policy is None else [policy.block_n, policy.splits,
                                        policy.window]
    out, stats, preacts = torch.ops.repro_torch.gemm_fused(
        a, b, b2, bias, residual, gamma, beta, sin, cos,
        chain_flags(epilogue), epilogue.head_dim, prologue.norm, prologue.eps,
        None if scale is None else float(scale), out_dtype, save_preact,
        plan)
    if obs.enabled() and _OP_RAN.ran:
        m, k = a.shape
        n = b.shape[1]
        journal("gemm_fused", a.device, t0, variant=bwd_mode,
                chain=f"{prologue.describe()}|{epilogue.describe()}",
                flops=(2 if epilogue.gate else 1) * 2 * m * n * k,
                policy=policy)
    return out, (stats if stats.numel() else None), tuple(preacts)



def _chain_of(flags: int, head_dim: int, norm: str, eps, has_beta: bool):
    """The (Epilogue, Prologue) that :func:`chain_flags` and the prologue's
    fields describe: the custom op's arguments back as the specs."""
    act = next(k for k, v in ACT_CODES.items()
               if v == flags >> _EP_ACT_SHIFT)
    epilogue = Epilogue(bias=bool(flags & _EP_BIAS), activation=act,
                        gate=bool(flags & _EP_GATE),
                        residual=bool(flags & _EP_RESIDUAL),
                        scale=bool(flags & _EP_SCALE),
                        rope=bool(flags & _EP_ROPE), head_dim=head_dim)
    return epilogue, Prologue(norm=norm, beta=has_beta, eps=eps)


@torch.library.custom_op("repro_torch::gemm_fused", mutates_args=())
def _gemm_fused_op(
        a: torch.Tensor, b: torch.Tensor, b2: Optional[torch.Tensor],
        bias: Optional[torch.Tensor], residual: Optional[torch.Tensor],
        gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
        sin: Optional[torch.Tensor], cos: Optional[torch.Tensor], flags: int,
        head_dim: int, norm: str, eps: Optional[float],
        scale: Optional[float], out_dtype: torch.dtype,
        save_preact: bool, plan: Optional[list[int]] = None
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """The plain version (any device but CUDA): (out, an empty stats
    tensor, preacts); ``plan`` (tile width, split, window) is the card's."""
    _OP_RAN.ran = True
    epilogue, prologue = _chain_of(flags, head_dim, norm, eps,
                                   beta is not None)
    out, _, preacts = forward_ref(
        a, b, epilogue, prologue, b2=b2, bias=bias, residual=residual,
        scale=scale, sin=sin, cos=cos, gamma=gamma, beta=beta,
        out_dtype=out_dtype, save_preact=save_preact)
    return out, a.new_empty(0, dtype=torch.float32), list(preacts)


@_gemm_fused_op.register_kernel("cuda")
def _gemm_fused_cuda(a, b, b2, bias, residual, gamma, beta, sin, cos, flags,
                     head_dim, norm, eps, scale, out_dtype, save_preact,
                     plan=None):
    """The kernel: one launch (:func:`_launch`, which counts it) at
    ``plan`` (tile width, split, window; None: the resolved policy's)."""
    _OP_RAN.ran = True
    epilogue, prologue = _chain_of(flags, head_dim, norm, eps,
                                   beta is not None)
    if plan is None:
        pol = launch_policy(a, b, epilogue, prologue)
        plan = [pol.block_n, pol.splits, pol.window]
    f32 = out_dtype == torch.float32
    if f32:
        # the raw accumulators at one split: _launch refuses any chain
        plan = [plan[0], 1, plan[2]]
    out, stats, preacts = _launch(
        a, b, epilogue, b2=b2, bias=bias, residual=residual, scale=scale,
        sin=sin, cos=cos, gamma=gamma, beta=beta, eps=eps,
        layernorm=norm == "layernorm",
        out_dtype=torch.bfloat16 if f32 else out_dtype,
        save_preact=save_preact, plan=plan, f32_product=f32)
    if stats is None:
        stats = a.new_empty(0, dtype=torch.float32)
    return out, stats, list(preacts)


@_gemm_fused_op.register_fake
def _gemm_fused_fake(a, b, b2, bias, residual, gamma, beta, sin, cos, flags,
                     head_dim, norm, eps, scale, out_dtype, save_preact,
                     plan=None):
    m, n = a.shape[0], b.shape[1]
    cuda = a.device.type == "cuda"
    stats = (0,)
    if cuda and gamma is not None:
        stats = (2, m) if norm == "layernorm" else (m,)
    epilogue, _ = _chain_of(flags, head_dim, norm, eps, beta is not None)
    saves = 0
    if save_preact:
        saves = (kernel_saves(epilogue) if cuda
                 else epilogue.n_accumulators)
    return (a.new_empty((m, n), dtype=out_dtype),
            a.new_empty(stats, dtype=torch.float32),
            [a.new_empty((m, n)) for _ in range(saves)])


def forward_ref(a, b, epilogue, prologue, *, b2, bias, residual, scale, sin,
                cos, gamma, out_dtype, beta=None, save_preact=False):
    """The plain version of :func:`_forward` on any device: (out, None,
    preacts)."""
    out = gemm_fused_ref(a, b, epilogue=epilogue, prologue=prologue, b2=b2,
                         bias=bias, residual=residual, scale=scale, sin=sin,
                         cos=cos, gamma=gamma, beta=beta, out_dtype=out_dtype)
    preacts = ()
    if save_preact:
        an = a
        if not prologue.is_identity:
            an = norm_rows_ref(a, prologue, gamma, beta)
        preacts = tuple((an.float() @ w.float()).to(a.dtype)
                        for w in ((b, b2) if epilogue.gate else (b,)))
    return out, None, preacts


class _GemmFusedFn(torch.autograd.Function):
    """gemm_fused under autograd. The forward keeps (a, b, the extras, the
    row statistics, the saved preacts); the backward is the kernel chain
    transpose or the oracle's autograd, with no grad for sin and cos."""

    @staticmethod
    def forward(ctx, a, b, b2, bias, residual, gamma, beta, sin, cos, spec):
        ep = spec.epilogue
        save = spec.bwd_mode == "kernel" and kernel_saves(ep) > 0
        out, stats, preacts = _forward(
            a, b, ep, spec.prologue, b2=b2, bias=bias, residual=residual,
            scale=spec.scale, sin=sin, cos=cos, gamma=gamma, beta=beta,
            out_dtype=spec.out_dtype, save_preact=save,
            bwd_mode=spec.bwd_mode, policy=spec.policy)
        ctx.spec = spec
        ctx.save_for_backward(a, b, b2, bias, residual, gamma, beta, sin,
                              cos, stats, *preacts)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, b2, bias, residual, gamma, beta, sin, cos, stats, *preacts = \
            ctx.saved_tensors
        spec = ctx.spec
        operands = (a, b, b2, bias, residual, gamma, beta, sin, cos)
        need = ctx.needs_input_grad[:len(operands)]
        if spec.bwd_mode == "reference":
            return (*_reference_vjp(spec, operands, need, g), None)
        from .backward import gemm_fused_bwd
        # an fp32 product's grad enters the bf16 transpose kernels rounded,
        # as a bf16 output's grad would
        g = g.to(a.dtype)
        da, db, grads = gemm_fused_bwd(
            a, b, g, epilogue=spec.epilogue, prologue=spec.prologue,
            b2=b2, bias=bias, scale=spec.scale, sin=sin, cos=cos,
            gamma=gamma, beta=beta, rstd=stats, preacts=tuple(preacts))
        extras = []
        for name, op, wanted in zip(_GRAD_OPERANDS, operands[2:], need[2:]):
            grad = grads.get(name) if wanted else None
            extras.append(None if grad is None
                          else grad.reshape(op.shape).to(op.dtype))
        return (da, db, *extras, None)


def _reference_vjp(spec, operands, need, g):
    """Autograd through the oracle, recomputing the forward."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(w)
                  for t, w in zip(operands, need)]
        a, b, b2, bias, residual, gamma, beta, sin, cos = leaves
        out = gemm_fused_ref(a, b, epilogue=spec.epilogue,
                             prologue=spec.prologue, b2=b2, bias=bias,
                             residual=residual, scale=spec.scale, sin=sin,
                             cos=cos, gamma=gamma, beta=beta,
                             out_dtype=spec.out_dtype)
        wanted = [t for t, w in zip(leaves, need) if t is not None and w]
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
    return tuple(next(grads) if t is not None and w else None
                 for t, w in zip(leaves, need))


def chain_flags(epilogue: Epilogue) -> int:
    """The chain as the C entry points' bit flags and activation code (also
    those of the backward operand pass, csrc/gemm_bwd_g.cu, which reads the
    bits only)."""
    return ((_EP_SCALE if epilogue.scale else 0)
            | (_EP_BIAS if epilogue.bias else 0)
            | (_EP_ROPE if epilogue.rope else 0)
            | (_EP_GATE if epilogue.gate else 0)
            | (_EP_RESIDUAL if epilogue.residual else 0)
            | ACT_CODES[epilogue.activation] << _EP_ACT_SHIFT)


def require(t, name, shape, dtype, device):
    """The pointer of a kernel operand, after checking its device, type,
    shape, contiguity and 16-byte alignment."""
    if t.device != device:
        raise ValueError(f"gemm_fused: {name} on {t.device}, A on {device}")
    if t.dtype != dtype:
        raise TypeError(f"gemm_fused kernel: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gemm_fused: {name} has shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"gemm_fused kernel: {name} must be contiguous and "
                         "16-byte aligned")
    return t.data_ptr()


def _launch(a, b, epilogue, *, b2, bias, residual, scale, sin, cos, gamma,
            eps, out_dtype, beta=None, layernorm=False, save_preact=False,
            plan=None, f32_product=False, kernel: CudaKernel = KERNEL):
    """One launch on the card: (out, stats, preacts), ``stats`` as
    :func:`_forward` returns them. With ``gamma`` the row pass normalises A
    first: layernorm (``beta`` optional) where ``layernorm``, else rmsnorm.
    ``plan`` (tile width, split count[, window]; window 8 when not given)
    overrides the resolved policy's (the smoke's sweeps); ``kernel``:
    another build of the same entry point (the smoke's A/B against an
    earlier tree). ``f32_product``: the chainless
    product at one split, returned in fp32 in place of ``out`` (the kernel
    writes its raw accumulators to a one-split workspace, the staged route;
    the collective GEMM's reduce-scatter panels)."""
    m, k = a.shape
    n = b.shape[1]
    dev, bf16 = a.device, torch.bfloat16
    if out_dtype != bf16:
        raise TypeError(f"gemm_fused kernel: out_dtype must be bfloat16, "
                        f"got {out_dtype}")
    if n % 8 or k % 8:
        raise ValueError(f"gemm_fused kernel: N ({n}) and K ({k}) must be "
                         "multiples of 8")
    if epilogue.rope and n % epilogue.head_dim:
        raise ValueError(f"gemm_fused: N ({n}) is not whole heads of "
                         f"{epilogue.head_dim}")
    hd = epilogue.head_dim if epilogue.rope else 0
    if plan is None:
        pol = launch_policy(a, b, epilogue, PROLOGUE_NONE if gamma is None
                            else Prologue(norm="layernorm" if layernorm
                                          else "rmsnorm", beta=beta is not None))
        plan = (pol.block_n, pol.splits, pol.window)
    tile_n, splits, window = (*plan, DEFAULT_WINDOW)[:3]
    if tile_n not in tile_widths(epilogue.gate, hd) or splits < 1 \
            or window < 1:
        raise ValueError(f"gemm_fused kernel: plan {tuple(plan)} does "
                         f"not fit chain {epilogue.describe()!r}")
    if f32_product and (splits != 1 or epilogue != EPILOGUE_NONE
                        or gamma is not None):
        raise ValueError("gemm_fused kernel: an fp32 product is the "
                         "chainless product at one split")
    ptr = {"a": require(a, "a", (m, k), bf16, dev),
           "b": require(b, "b", (k, n), bf16, dev)}
    null = None
    if b2 is not None:
        ptr["b2"] = require(b2, "b2", (k, n), bf16, dev)
    if gamma is not None:
        ptr["gamma"] = require(gamma, "gamma", (k,), bf16, dev)
    if beta is not None:
        if not layernorm:
            raise ValueError("gemm_fused kernel: beta needs the layernorm "
                             "prologue")
        ptr["beta"] = require(beta, "beta", (k,), bf16, dev)
    if bias is not None:
        ptr["bias"] = require(bias, "bias", (n,), bf16, dev)
    if residual is not None:
        ptr["residual"] = require(residual, "residual", (m, n), bf16, dev)
    if sin is not None:
        ptr["sin"] = require(sin, "sin", (m, hd), torch.float32, dev)
        ptr["cos"] = require(cos, "cos", (m, hd), torch.float32, dev)
    flags = chain_flags(epilogue)
    out = torch.empty((m, n), dtype=bf16, device=dev)
    stats = mean = rstd = an = ws = None
    if gamma is not None:
        # one buffer: rstd (M,), or for layernorm mean and rstd (2, M)
        stats = torch.empty((2, m) if layernorm else (m,),
                            dtype=torch.float32, device=dev)
        mean, rstd = (stats[0], stats[1]) if layernorm else (None, stats)
        an = torch.empty((m, k), dtype=bf16, device=dev)
    if staged(epilogue, splits) or f32_product:
        ws = torch.empty((splits, m, raw_width(n, tile_n, epilogue.gate)),
                         dtype=torch.float32, device=dev)
    # the raw accumulators of an activation chain: one, or the gate's two
    preacts = tuple(torch.empty((m, n), dtype=bf16, device=dev)
                    for _ in range(kernel_saves(epilogue) if save_preact
                                   else 0))

    def addr(t):
        return None if t is None else t.data_ptr()

    fn = kernel.fn()
    stream = kernel.stream(dev)
    kernel.launches += 1
    code = fn(ptr["a"], ptr["b"], ptr.get("b2", null), out.data_ptr(),
              ptr.get("gamma", null), ptr.get("beta", null), addr(mean),
              addr(rstd), addr(an),
              ptr.get("bias", null), ptr.get("residual", null),
              ptr.get("sin", null), ptr.get("cos", null),
              *[addr(p) for p in (*preacts, None, None)[:2]], addr(ws),
              float(scale) if scale is not None else 1.0,
              float(eps) if eps is not None else 0.0,
              m, n, k, flags, epilogue.head_dim, tile_n, splits, window,
              stream)
    kernel.check(code)
    return (ws[0] if f32_product else out), stats, preacts
