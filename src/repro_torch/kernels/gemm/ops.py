"""``gemm_fused``: the fused GEMM op.

A CPU tensor runs the plain version (:func:`gemm_fused_ref`); a CUDA tensor
launches the hand-written kernel (``csrc/gemm_fused.cu``) or raises. The
chains the kernel takes are checked on both devices, so a call the CPU
accepts is one the card accepts too:

* prologue ``none`` or ``rmsnorm`` (row statistics computed in the launch);
* epilogue stages scalar ``scale``, ``bias``, ``rope``, ``silu`` with
  ``gate`` (the dual-output SwiGLU up-projection) and ``residual``.

On the card every operand is bf16 (sin/cos fp32), contiguous and 16-byte
aligned, with N and K multiples of 8.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel
from .epilogue import EPILOGUE_NONE, Epilogue
from .prologue import PROLOGUE_NONE, Prologue
from .ref import gemm_fused_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "gemm_fused", "gemm_fused.cu", "gemm_fused_launch",
    [_P] * 10 + [_F, _F] + [_I] * 5 + [_P])

# bit flags of the C entry point (csrc/gemm_fused.cu)
_EP_SCALE, _EP_BIAS, _EP_ROPE, _EP_GATE_SILU, _EP_RESIDUAL = 1, 2, 4, 8, 16
# the kernel's non-gated block width: rope needs whole heads per block
BLOCK_N = 128


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


def check_chain(epilogue: Epilogue, prologue: Prologue) -> None:
    """Raise on a chain the CUDA kernel does not take."""
    if prologue.norm not in ("none", "rmsnorm") or prologue.precomputed_stats:
        raise NotImplementedError(
            f"gemm_fused kernel: prologue {prologue.describe()!r} is not "
            "supported (rmsnorm with in-launch statistics only)")
    if epilogue.scale_kind != "scalar":
        raise NotImplementedError(
            "gemm_fused kernel: per-row/per-column scales are not supported")
    if epilogue.activation not in ("none", "silu") or (
            epilogue.activation == "silu" and not epilogue.gate):
        raise NotImplementedError(
            f"gemm_fused kernel: activation {epilogue.activation!r} "
            f"(gate={epilogue.gate}) is not supported; silu with gate only")
    if epilogue.rope and BLOCK_N % epilogue.head_dim:
        raise NotImplementedError(
            f"gemm_fused kernel: rope head_dim {epilogue.head_dim} does not "
            f"divide the kernel's block width {BLOCK_N}")


def gemm_fused(a, b, *, epilogue: Epilogue = EPILOGUE_NONE,
               prologue: Prologue = PROLOGUE_NONE, b2=None, bias=None,
               residual=None, scale=None, sin=None, cos=None,
               gamma=None, beta=None, mean=None, rstd=None,
               out_dtype=torch.bfloat16):
    """C = epilogue(prologue(A) @ B [, A @ B2]) in one launch on the card.

    a (M, K), b and b2 (K, N); gamma (K,); bias (N,); residual (M, N);
    scale a scalar; sin/cos (M, head_dim) fp32 duplicated-halves tables.
    """
    provided = dict(b2=b2, bias=bias, residual=residual, scale=scale,
                    sin=sin, cos=cos)
    pro_provided = dict(gamma=gamma, beta=beta, mean=mean, rstd=rstd)
    _check_operands(epilogue, prologue, provided, pro_provided)
    check_chain(epilogue, prologue)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_fused: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not multiply")
    if a.device.type == "cpu":
        return gemm_fused_ref(a, b, epilogue=epilogue, prologue=prologue,
                              b2=b2, bias=bias, residual=residual,
                              scale=scale, sin=sin, cos=cos, gamma=gamma,
                              beta=beta, mean=mean, rstd=rstd,
                              out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_fused: unsupported device {a.device}")
    return _launch(a, b, epilogue, b2=b2, bias=bias, residual=residual,
                   scale=scale, sin=sin, cos=cos, gamma=gamma,
                   eps=prologue.eps, out_dtype=out_dtype)


def _require(t, name, shape, dtype, device):
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
            eps, out_dtype):
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
    ptr = {"a": _require(a, "a", (m, k), bf16, dev),
           "b": _require(b, "b", (k, n), bf16, dev)}
    null = None
    if b2 is not None:
        ptr["b2"] = _require(b2, "b2", (k, n), bf16, dev)
    if gamma is not None:
        ptr["gamma"] = _require(gamma, "gamma", (k,), bf16, dev)
    if bias is not None:
        ptr["bias"] = _require(bias, "bias", (n,), bf16, dev)
    if residual is not None:
        ptr["residual"] = _require(residual, "residual", (m, n), bf16, dev)
    if sin is not None:
        hd = epilogue.head_dim
        ptr["sin"] = _require(sin, "sin", (m, hd), torch.float32, dev)
        ptr["cos"] = _require(cos, "cos", (m, hd), torch.float32, dev)
    flags = ((_EP_SCALE if epilogue.scale else 0)
             | (_EP_BIAS if epilogue.bias else 0)
             | (_EP_ROPE if epilogue.rope else 0)
             | (_EP_GATE_SILU if epilogue.gate else 0)
             | (_EP_RESIDUAL if epilogue.residual else 0))
    out = torch.empty((m, n), dtype=bf16, device=dev)
    rstd = (torch.empty((m,), dtype=torch.float32, device=dev)
            if gamma is not None else None)
    fn = KERNEL.fn()
    stream = KERNEL.stream(dev)
    KERNEL.launches += 1
    code = fn(ptr["a"], ptr["b"], ptr.get("b2", null), out.data_ptr(),
              ptr.get("gamma", null),
              None if rstd is None else rstd.data_ptr(),
              ptr.get("bias", null), ptr.get("residual", null),
              ptr.get("sin", null), ptr.get("cos", null),
              float(scale) if scale is not None else 1.0,
              float(eps) if eps is not None else 0.0,
              m, n, k, flags, epilogue.head_dim, stream)
    KERNEL.check(code)
    return out
