"""Config registry: ``get_config('<arch-id>')`` for the archs the port runs."""
from __future__ import annotations

from .base import ModelConfig  # noqa: F401
from .llama_paper import LLAMA_100M, LLAMA_1B

_CONFIGS = {"llama-100m": LLAMA_100M, "llama-1b": LLAMA_1B}
ARCH_IDS = tuple(_CONFIGS)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    """The published config. ``smoke`` is accepted for the reference's call
    signature and ignored: the llama validation models have no smoke
    variant there either."""
    del smoke
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_CONFIGS)}")
    return _CONFIGS[name]
