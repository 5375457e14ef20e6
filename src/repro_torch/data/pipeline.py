"""The reference's deterministic synthetic LM data, in numpy.

The port's own copy of the numpy half of the reference pipeline: the same
per-(step, row) Philox streams, so ``batch_at`` gives the reference's
batches bit for bit. Tokens follow a noisy affine-modular chain (next =
(mult * prev + add) mod V with probability 1 - noise, else uniform), packed
as geometric-length documents into fixed windows with a loss mask that
drops each document's first target. ``DataIterator`` yields the batches as
tensors on a device; its state is the integer step. Over a mesh each rank
takes only its own rows of the global batch (:func:`local_rows`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.2         # probability of a uniform-random token
    mean_doc_len: int = 256    # geometric packing
    mult: int = 31             # affine chain multiplier
    add: int = 7


def _rng_for(cfg: DataConfig, step: int, row: int) -> np.random.Generator:
    # a stable stream per (step, row), whatever the batch layout
    return np.random.Generator(np.random.Philox(
        key=cfg.seed, counter=[step, row, 0, 0]))


def _sample_row(cfg: DataConfig, step: int, row: int) -> tuple:
    """(tokens (S+1,), doc_starts (S+1,) bool) of one packed row."""
    rng = _rng_for(cfg, step, row)
    s = cfg.seq_len + 1
    toks = np.empty(s, np.int32)
    starts = np.zeros(s, bool)
    i = 0
    while i < s:
        doc_len = 1 + rng.geometric(1.0 / cfg.mean_doc_len)
        doc_len = min(doc_len, s - i)
        starts[i] = True
        t = rng.integers(0, cfg.vocab_size)
        for j in range(doc_len):
            toks[i + j] = t
            if rng.random() < cfg.noise:
                t = rng.integers(0, cfg.vocab_size)
            else:
                t = (cfg.mult * t + cfg.add) % cfg.vocab_size
        i += doc_len
    return toks, starts


def batch_rows(cfg: DataConfig, step: int, rows: range) -> dict:
    pairs = [_sample_row(cfg, step, r) for r in rows]
    toks = np.stack([p[0] for p in pairs])
    starts = np.stack([p[1] for p in pairs])
    # no loss where the target starts a new (unrelated) document
    loss_mask = (~starts[:, 1:]).astype(np.float32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "loss_mask": loss_mask}


def batch_at(cfg: DataConfig, step: int) -> dict:
    """The global batch of ``step`` as host arrays."""
    return batch_rows(cfg, step, range(cfg.global_batch))


def local_rows(cfg: DataConfig, mesh, batch_axes=("data",),
               coords: dict | None = None) -> range:
    """The rows of the global batch that the rank at ``coords`` (default:
    this rank's) holds: its block along ``batch_axes`` where they divide
    the batch (the reference's ``global_batch_at``), else every row."""
    from repro_torch.distributed.sharding import (block_index,
                                                  divisible_axes,
                                                  mesh_coords)

    axes = divisible_axes(cfg.global_batch, mesh, batch_axes)
    if not axes:
        return range(cfg.global_batch)
    coords = mesh_coords(mesh) if coords is None else coords
    index, count = block_index(axes, mesh, coords)
    rows = cfg.global_batch // count
    return range(index * rows, (index + 1) * rows)


class DataIterator:
    """Yields ``batch_at(cfg, step)`` as tensors on ``device`` (tokens
    int64, the mask fp32), or over a ``mesh`` this rank's rows of it
    (:func:`local_rows`); its state is the integer step."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 device=DEFAULT_DEVICE, *, mesh=None, batch_axes=("data",)):
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)
        self.rows = (range(cfg.global_batch) if mesh is None
                     else local_rows(cfg, mesh, batch_axes))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = batch_rows(self.cfg, self.step, self.rows)
        self.step += 1
        return {k: torch.from_numpy(v).to(
            self.device, torch.float32 if k == "loss_mask" else torch.int64)
            for k, v in b.items()}

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
