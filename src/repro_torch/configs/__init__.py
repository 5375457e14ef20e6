"""Config registry: ``get_config('<arch-id>'[, smoke=True])`` for the archs
the port runs (the dense decoders, mixtral-8x7b's mixture of experts,
llama4-maverick's dense and mixture-of-experts layers interleaved,
mamba2-130m's SSD blocks, recurrentgemma-2b's hybrid of RG-LRU and
local-attention blocks, internvl2-2b's vision-language backbone,
whisper-base and bert-110m), under the reference's ids; and the shipped
pretuned-table resolver (``pretuned_table_path``,
``load_shipped_pretuned``)."""
from __future__ import annotations

import importlib
import os

from .base import (DECODER_FAMILIES, ModelConfig, MoEConfig,  # noqa: F401
                   RGLRUConfig, SSMConfig)

_MODULES = {
    "whisper-base": "whisper_base",
    "minicpm-2b": "minicpm_2b",
    "chatglm3-6b": "chatglm3_6b",
    "granite-8b": "granite_8b",
    "qwen2-72b": "qwen2_72b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-2b": "internvl2_2b",
    "llama-100m": "llama_paper",
    "llama-1b": "llama_paper",
    "bert-110m": "llama_paper",
}
ARCH_IDS = tuple(_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    """The published config, or with ``smoke`` its small variant. The
    paper's validation models (llama-100m, llama-1b, bert-110m) have no
    smoke variant (as in the reference) and return their one config either
    way."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    if name == "llama-100m":
        return mod.LLAMA_100M
    if name == "llama-1b":
        return mod.LLAMA_1B
    if name == "bert-110m":
        return mod.BERT_110M
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


_PRETUNED_DIR = os.path.join(os.path.dirname(__file__), "pretuned")


def pretuned_table_path(arch: str | None = None) -> str | None:
    """Path of the shipped pretuned policy table for ``arch`` (by default
    the device's: "h100" on an H100, "cpu" without CUDA), or None when no
    table was calibrated for it. ``launch/calibrate.py`` writes the tables;
    they live beside the configs so a checkout carries its calibration."""
    if arch is None:
        from repro_torch.core.autotune import default_arch
        arch = default_arch()
    path = os.path.join(_PRETUNED_DIR, f"{arch}.json")
    return path if os.path.exists(path) else None


def load_shipped_pretuned(arch: str | None = None) -> bool:
    """Install the shipped table for ``arch`` into the autotuner; False
    (selection stays analytic) when none is shipped or the table is
    rejected (a schema or arch mismatch, counted by ``obs``)."""
    path = pretuned_table_path(arch)
    if path is None:
        return False
    from repro_torch.core import autotune
    return autotune.load_pretuned(path, arch=arch)
