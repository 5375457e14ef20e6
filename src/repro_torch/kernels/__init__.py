"""Hand-written Hopper kernels of the port, each beside its plain version.

``KERNELS`` lists every CUDA kernel with its launch count; ``build_all``
compiles them in parallel (``_build.build_all``). A CUDA graph's replay
adds the launches its capture recorded (``add_launch_counts``).
"""
from ._build import build_all as _build_all
from .attention import (BWD_KERNEL, DECODE_KERNEL, DECODE_PAGED_KERNEL,
                        FWD_KERNEL)
from .fused_norm import (KERNEL as FUSED_NORM_KERNEL,  # noqa: F401
                         dropout_residual_layernorm)
from .gemm import DA_KERNEL, DB_KERNEL, G_KERNEL, KERNEL as GEMM_KERNEL
from .rope import KERNEL as ROPE_KERNEL, rope  # noqa: F401

KERNELS = (GEMM_KERNEL, FWD_KERNEL, DECODE_KERNEL, DECODE_PAGED_KERNEL,
           G_KERNEL, DA_KERNEL, DB_KERNEL, BWD_KERNEL, ROPE_KERNEL,
           FUSED_NORM_KERNEL)


def build_all() -> dict:
    return _build_all(KERNELS)


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` {name: n} to the kernels' launch counts: a CUDA
    graph's replay launches what its capture recorded, and the wrappers,
    which count on the host, do not run."""
    for k in KERNELS:
        k.launches += counts.get(k.name, 0)
