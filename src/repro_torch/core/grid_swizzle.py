"""HipKittens Algorithm 1 -- the cache-aware grid swizzle -- on Hopper.

The paper remaps flattened GEMM block IDs in two steps:
  1. *XCD grouping*: chunks of ``C`` consecutive remapped IDs land on the
     same XCD under the hardware's round-robin dispatch;
  2. *Hierarchical windowed traversal*: the flattened ID space is folded
     into vertical windows of height ``W`` so blocks sharing rows of A /
     columns of B execute near each other in time (L2 reuse).

On the H100 there are no chiplets: every SM reads the one 50 MB L2, so step
1 is off (``n_xcd = 1`` in every policy the port builds). Step 2 is the
walk of the persistent GEMM kernels (``csrc/gemm_sm90.cuh`` ``tile_coords``):
block ``b`` takes tiles ``b, b + grid, ...``, each mapped through
:func:`windowed_traversal` with the policy's window (the kernel's
``group_m``), so the tiles running at one time share ``window`` rows of A
and a few columns of B in L2. :func:`tile_coords` is that walk in Python.

The functions are pure numpy (the port traces nothing) and give the
reference's results for every argument, the defaults included.
"""
from __future__ import annotations

import dataclasses
import numpy as np

N_XCD_DEFAULT = 8  # the paper's MI355X has 8 XCDs; kept as the default
# the windows the port's policies name (the GEMM kernels' group_m); 8 is the
# kernels' walk before the window became an argument, and every launch's
# window with no pretuned table installed
WINDOWS = (1, 4, 8, 16)
DEFAULT_WINDOW = 8


def chiplet_transform_chunked(xy, blocks, n_xcd, chunk):
    """Step 1 of Algorithm 1 (paper's ``chiplet_transform_chunked``).

    Remaps a flattened block id so that, under round-robin dispatch across
    ``n_xcd`` clusters, chunks of ``chunk`` consecutive *remapped* ids are
    resident on the same cluster. Bijective on [0, blocks).
    """
    xp = np
    blocks_per_cycle = n_xcd * chunk
    limit = (blocks // blocks_per_cycle) * blocks_per_cycle
    xcd = xy % n_xcd
    local = xy // n_xcd
    chunk_idx = local // chunk
    pos = local % chunk
    remapped = chunk_idx * blocks_per_cycle + xcd * chunk + pos
    return xp.where(xy >= limit, xy, remapped)


def windowed_traversal(xy, num_rows, num_cols, window):
    """Step 2 of Algorithm 1: fold flattened ids into vertical windows.

    Returns (row, col). Within a window of ``window`` rows the fast index goes
    *down a column* (so the B column-block is reused by ``window`` consecutive
    blocks); after ``win_h`` rows we move to the next column.
    """
    xp = np
    tid_per_group = window * num_cols
    group_id = xy // tid_per_group
    first_row = group_id * window
    win_h = xp.minimum(num_rows - first_row, window)
    l = xy % tid_per_group
    row = first_row + (l % win_h)
    col = l // win_h
    return row, col


@dataclasses.dataclass(frozen=True)
class SwizzleConfig:
    """Parameters of Algorithm 1. ``window``/``chunk`` trade L2 vs LLC reuse
    in the paper; here they trade B-block revisit runs vs A working-set span."""

    window: int = 8
    chunk: int = 64
    n_xcd: int = N_XCD_DEFAULT
    enable_chiplet: bool = True   # step 1 on/off (off for single-core Pallas use)
    enable_window: bool = True    # step 2 on/off (off => row-major)

    def remap(self, xy, num_rows, num_cols):
        """Full Algorithm 1: flattened id -> (row, col) block coordinates."""
        blocks = num_rows * num_cols
        if self.enable_chiplet:
            xy = chiplet_transform_chunked(xy, blocks, self.n_xcd, self.chunk)
        if self.enable_window:
            return windowed_traversal(xy, num_rows, num_cols, self.window)
        return xy // num_cols, xy % num_cols


ROW_MAJOR = SwizzleConfig(enable_chiplet=False, enable_window=False)


def schedule_order(cfg: SwizzleConfig, num_rows: int, num_cols: int) -> np.ndarray:
    """(blocks, 2) array of (row, col) in execution order — for simulators."""
    xy = np.arange(num_rows * num_cols)
    r, c = cfg.remap(xy, num_rows, num_cols)
    return np.stack([np.asarray(r), np.asarray(c)], axis=1)


def is_permutation(cfg: SwizzleConfig, num_rows: int, num_cols: int) -> bool:
    """Every output block is produced exactly once."""
    order = schedule_order(cfg, num_rows, num_cols)
    flat = order[:, 0] * num_cols + order[:, 1]
    return (np.sort(flat) == np.arange(num_rows * num_cols)).all() and \
        (order[:, 0] < num_rows).all() and (order[:, 1] < num_cols).all() and \
        (order >= 0).all()


def dma_bytes(cfg: SwizzleConfig, num_rows: int, num_cols: int,
              a_block_bytes: int, b_block_bytes: int) -> int:
    """Panel traffic of a full-K blocked GEMM under a consecutive-revisit
    rule: an operand panel is fetched again whenever the block index changes
    from one tile to the next (A panels by row, B panels by column). The
    reference's Pallas pipeline has that rule; on Hopper it is the traffic
    of one SM walking the order alone, a bound on what L2 must absorb. The
    many-SM cache level is :mod:`repro_torch.core.cache_model`'s."""
    order = schedule_order(cfg, num_rows, num_cols)
    rows, cols = order[:, 0], order[:, 1]
    a_fetches = 1 + int(np.count_nonzero(rows[1:] != rows[:-1]))
    b_fetches = 1 + int(np.count_nonzero(cols[1:] != cols[:-1]))
    return a_fetches * a_block_bytes + b_fetches * b_block_bytes


def best_window(num_rows: int, num_cols: int, a_block_bytes: int,
                b_block_bytes: int, candidates=(1, 2, 4, 8, 16, 32)) -> SwizzleConfig:
    """Pick the window minimizing modeled DMA traffic (autotuning hook)."""
    best = None
    for w in candidates:
        if w > num_rows:
            continue
        cfg = SwizzleConfig(window=w, enable_chiplet=False)
        traffic = dma_bytes(cfg, num_rows, num_cols, a_block_bytes, b_block_bytes)
        if best is None or traffic < best[0]:
            best = (traffic, cfg)
    return best[1] if best else ROW_MAJOR


def tile_coords(t: int, tiles_m: int, tiles_n: int, window: int) -> tuple:
    """Tile ``t`` of the GEMM kernels' persistent walk -> (tile row, tile
    column): ``window`` tile rows at a time, column by column within them.
    The Python mirror of ``tile_coords`` in ``csrc/gemm_sm90.cuh``, which
    :func:`windowed_traversal` computes for every window."""
    per_group = window * tiles_n
    first = (t // per_group) * window
    rows = min(tiles_m - first, window)
    r = t % per_group
    return first + r % rows, r // rows
