"""Tile legality on Hopper: the budget that bounds a kernel's tiles.

The reference bounds a Pallas kernel's tiles by VMEM: every pipelined operand
block, ``n_buffers`` deep, plus the pinned fp32 scratch must fit 128 MiB
(``repro/core/tiles.py``). On the H100 the same argument bounds a block's
**shared memory** (the TMA ring's stages, 227 KB a block at most) and its
**registers** (a consumer warpgroup's wgmma accumulators, 255 a thread at
most; the GEMM's consumers take 232 by ``setmaxnreg``). A tile that blows
either budget does not compile or spills, so the autotuner never names one.

``TileSpec`` keeps the reference's name for a legal 2-D tile: its rows a
multiple of a warpgroup's 64 (wgmma's M), its row 16-byte aligned (TMA).
There is no ``block_spec``: the port builds no Pallas BlockSpec.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# ---------------------------------------------------------------------------
# H100 SXM facts (CUDA programming guide, compute capability 9.0)
# ---------------------------------------------------------------------------
SMS = 132                          # streaming multiprocessors
SMEM_PER_BLOCK = 232448            # dynamic shared memory a block may opt in to
SMEM_PER_SM = 233472
REGS_PER_SM = 65536
MAX_REGS_PER_THREAD = 255
L2_BYTES = 50 * 2**20
WARPGROUP = 128                    # threads a warpgroup
WGMMA_M = 64                       # rows a warpgroup's wgmma covers
TMA_ROW_BYTES = 128                # one swizzled TMA box row

# The forward and backward GEMM mainloop (csrc/gemm_sm90.cuh): BM x BK
# stages of X, BN x BK of Y, a ring of at most RING_BYTES, one producer and
# CONSUMERS consumer warpgroups, the consumers raised to CONSUMER_REGS.
GEMM_BM, GEMM_BK, GEMM_CONSUMERS = 128, 64, 2
GEMM_RING_BYTES = 192 * 1024
GEMM_WIDTHS = (64, 128, 256)
CONSUMER_REGS, PRODUCER_REGS = 232, 40

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1,
             "float8_e4m3fn": 1, "float8_e5m2": 1}


def itemsize(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in _ITEMSIZE:
        raise ValueError(f"unsupported dtype for tiles: {dtype}")
    return _ITEMSIZE[name]


def native_tiling(dtype) -> tuple:
    """(rows, cols) of the smallest legal tile: a warpgroup's 64 rows by one
    128-byte TMA box row of ``dtype``."""
    return (WGMMA_M, TMA_ROW_BYTES // itemsize(dtype))


def is_aligned(shape: Sequence[int], dtype) -> bool:
    """True if the trailing dims of ``shape`` are native-tile multiples."""
    if len(shape) == 0:
        return False
    rows, cols = native_tiling(dtype)
    if len(shape) == 1:
        return shape[-1] % cols == 0
    return shape[-1] % cols == 0 and shape[-2] % rows == 0


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """A 2-D tile of ``dtype`` in shared memory: rows a multiple of 64 (a
    warpgroup's wgmma), a row a multiple of 16 bytes (a TMA box)."""

    rows: int
    cols: int
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError(f"tile dims must be positive, got "
                             f"{self.rows}x{self.cols}")
        if self.rows % WGMMA_M:
            raise ValueError(f"tile rows {self.rows} not a multiple of "
                             f"{WGMMA_M} (a warpgroup's wgmma)")
        if (self.cols * itemsize(self.dtype)) % 16:
            raise ValueError(f"tile row of {self.cols} {self.dtype} is not "
                             "a multiple of 16 bytes (TMA)")

    @property
    def shape(self) -> tuple:
        return (self.rows, self.cols)

    @property
    def nbytes(self) -> int:
        return self.rows * self.cols * itemsize(self.dtype)


def gemm_stage_bytes(block_n: int) -> int:
    """One stage of the GEMM ring: a 128 x 64 X tile and a BN x 64 Y tile
    of bf16 (``Tile<BN>::STAGE_BYTES``)."""
    return (GEMM_BM + block_n) * GEMM_BK * 2


def gemm_stages(block_n: int) -> int:
    """Stages of the GEMM ring at tile width ``block_n`` (8, 6 and 4 at
    64, 128 and 256: ``Tile<BN>::STAGES``)."""
    return GEMM_RING_BYTES // gemm_stage_bytes(block_n)


def gemm_smem_bytes(block_n: int, stages: int | None = None) -> int:
    """Shared memory of a GEMM block: the stages, 1024 bytes to align them
    for the swizzle, two mbarriers a stage (``Tile<BN>::SMEM``)."""
    stages = gemm_stages(block_n) if stages is None else stages
    return stages * gemm_stage_bytes(block_n) + 1024 + 2 * stages * 8


def accumulator_registers(block_n: int, n_acc: int = 1) -> int:
    """fp32 accumulator registers a consumer thread holds: an m64nBN wgmma
    spreads 64 x BN over 128 threads, BN / 2 each (times the accumulators
    a chain keeps, the gated store's two being one BN-wide tile)."""
    return n_acc * block_n // 2


def check_smem_budget(smem_bytes: int, *, budget: int = SMEM_PER_BLOCK,
                      what: str = "kernel") -> int:
    if smem_bytes > budget:
        raise ValueError(f"{what}: {smem_bytes / 1024:.1f} KiB of shared "
                         f"memory exceeds {budget / 1024:.1f} KiB a block")
    return smem_bytes


def check_register_budget(regs: int, *, budget: int = CONSUMER_REGS,
                          what: str = "kernel") -> int:
    if regs > budget:
        raise ValueError(f"{what}: {regs} registers a thread exceed the "
                         f"consumers' {budget}")
    return regs
