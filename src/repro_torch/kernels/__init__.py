"""Hand-written Hopper kernels of the port, each beside its plain version.

``KERNELS`` lists every CUDA kernel with its launch count; ``build_all``
compiles them in parallel (``_build.build_all``). A CUDA graph's replay
adds the launches its capture recorded (``replay_launches``), and keeps them
apart too (``replayed_launch_counts``): a replay journals nothing into
``repro_torch.obs``, so a capture's events per kernel (``journal_counts``)
equal the launch counts less the replayed ones.
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


# the journal's ops (obs.LaunchEvent.op, or (op, variant)) -> the kernel
# that launches them: the reference's op names, and the port's launches the
# reference journals nothing for under their kernel's name (the GEMM
# backward's operand pass; the flash backward's dq conversion, variant
# "dq_convert")
JOURNAL_KERNELS = {
    "gemm_fused": "gemm_fused", "attention_fwd": "flash_attention_fwd",
    "attention_decode": "flash_decode",
    ("attention_decode", "paged"): "flash_decode_paged",
    "gemm_bwd_g": "gemm_bwd_g", "gemm_bwd_da": "gemm_bwd_da",
    "gemm_bwd_db": "gemm_bwd_db", "attention_bwd": "flash_attention_bwd",
    "flash_attention_bwd": "flash_attention_bwd", "rope": "rope",
    "fused_norm": "fused_norm"}
_REPLAYED: dict = {}


def build_all() -> dict:
    return _build_all(KERNELS)


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def replayed_launch_counts() -> dict:
    """The launches that CUDA graph replays added to the counts."""
    return {k.name: _REPLAYED.get(k.name, 0) for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    _REPLAYED.clear()


def journal_counts(recorder) -> dict:
    """{kernel name: events} of an ``obs`` recorder's launch journal."""
    out = {k.name: 0 for k in KERNELS}
    for e in recorder.launches:
        out[JOURNAL_KERNELS.get((e.op, e.variant))
            or JOURNAL_KERNELS[e.op]] += 1
    return out


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` {name: n} to the kernels' launch counts: a CUDA
    graph's replay launches what its capture recorded, and the wrappers,
    which count on the host, do not run."""
    for k in KERNELS:
        k.launches += counts.get(k.name, 0)


def replay_launches(counts: dict) -> None:
    """A CUDA graph's replay: ``add_launch_counts(counts)``, tallied apart
    as replayed."""
    add_launch_counts(counts)
    for name, n in counts.items():
        _REPLAYED[name] = _REPLAYED.get(name, 0) + n
