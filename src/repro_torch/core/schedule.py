"""Kernel schedules (paper §3.3) as the port's Hopper kernels run them.

HipKittens names two schedules that reach peak on AMD, 8-wave PING-PONG and
4-wave INTERLEAVE, and shows that NVIDIA-style wave specialization (a
producer wave feeding consumer waves) loses there, because the producer's
statically partitioned registers do no math. On Hopper the producer is one
warpgroup that gives its registers back (``setmaxnreg``) and issues TMA
loads that need none, so wave specialization is the card's own schedule:
every GEMM and flash kernel of the port runs one producer warpgroup and two
consumer warpgroups over a ring of shared-memory stages.

The reference's fields map as follows:

  n_buffers          the ring's stages (TMA stages in flight)
  block_m/n/k        rows / columns of a work item's output tile and the
                     contraction a stage carries, per op kind (policy.py)
  producer_fraction  0 here: the producer warpgroup costs registers the
                     consumers get back, not shared memory
  splits             (port only) the contraction's split count of a GEMM,
                     or a decode unit's key splits
  consumers          (port only) consumer warpgroups

``PINGPONG`` and ``INTERLEAVE`` keep the reference's names for reports; no
kernel of the port runs them (there is no 8-wave or 4-wave schedule on
Hopper). ``WAVE_SPECIALIZED`` is the schedule every port kernel runs.
"""
from __future__ import annotations

import dataclasses

from . import tiles


@dataclasses.dataclass(frozen=True)
class Schedule:
    name: str
    n_buffers: int                 # stages of the shared-memory ring
    block_m: int
    block_n: int
    block_k: int
    producer_fraction: float = 0.0
    splits: int = 1
    consumers: int = tiles.GEMM_CONSUMERS

    def smem_budget(self) -> int:
        return int(tiles.SMEM_PER_BLOCK * (1.0 - self.producer_fraction))

    def operand_blocks(self, dtype_bytes: int = 2):
        dt = "bfloat16" if dtype_bytes == 2 else "float32"
        return [((self.block_m, self.block_k), dt),
                ((self.block_k, self.block_n), dt)]


# The GEMM mainloop at its widest tile: 128 x 256 outputs, 64-deep stages,
# four of them in 192 KB, one producer and two consumer warpgroups.
WAVE_SPECIALIZED = Schedule("wave_specialized", n_buffers=4, block_m=128,
                            block_n=256, block_k=64)
# The reference's AMD presets, kept by name; no port kernel runs them.
PINGPONG = Schedule("pingpong", n_buffers=2, block_m=256, block_n=256,
                    block_k=64, consumers=2)
INTERLEAVE = Schedule("interleave", n_buffers=3, block_m=128, block_n=128,
                      block_k=64, consumers=1)

_SCHEDULES = {s.name: s for s in (PINGPONG, INTERLEAVE, WAVE_SPECIALIZED)}


def get_schedule(name: str) -> Schedule:
    if name not in _SCHEDULES:
        raise KeyError(f"unknown schedule {name!r}; have {sorted(_SCHEDULES)}")
    return _SCHEDULES[name]


def all_schedules():
    return list(_SCHEDULES.values())
