"""Device resolution for every entry point of the port.

Entry points default to ``device="cuda"`` and run on the CPU only when the
caller asks for it. Asking for CUDA on a machine without a card raises: the
port never carries on quietly on the CPU.

fp32 numerics on the card are pinned once, here: matrix products and
convolutions in full fp32 (TF32 off, matmul precision "highest"), so an
fp32 run on the card is an fp32 reference and not a TF32 one.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is available; "
                "pass device='cpu' to run the plain versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def dtype_of(name) -> torch.dtype:
    """'bfloat16' / 'float32' / a torch.dtype -> torch.dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
