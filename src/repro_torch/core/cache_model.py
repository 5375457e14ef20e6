"""Cache simulator for grid schedules (paper Table 4 / Eq. 1).

The paper evaluates grid schedules by their L2 and LLC hit rates and combines
them into an effective bandwidth:

    BW = L2_bw * L2_hit% + LLC_bw * LLC_hit%            (Eq. 1, extended with
                                                         the HBM miss term)

The simulator dispatches blocks round-robin across ``n_clusters``, each
cluster owning a private LRU L2, all clusters sharing an LRU LLC. A GEMM
block (i, j) requests the A-row panel tiles (i, k) and B-column panel tiles
(k, j) for all k. It reports hit rates, Eq.-1 effective bandwidth and a
modeled kernel time, which is how ``autotune.refine_with_cache_model``
scores swizzle windows. The default :class:`CacheHW` is the paper's MI355X
(so the results equal the reference's for the same arguments);
:meth:`CacheHW.h100` is the card the port runs on: one cluster of 132 SMs
over one 50 MB L2, no last-level cache, HBM3 behind it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from .grid_swizzle import SwizzleConfig, schedule_order


@dataclasses.dataclass(frozen=True)
class CacheHW:
    """Hardware model. Defaults follow the paper's MI355X description;
    :meth:`h100` is the H100 SXM the port targets."""

    n_clusters: int = 8
    executors_per_cluster: int = 32
    l2_bytes: int = 4 * 2**20
    llc_bytes: int = 256 * 2**20
    l2_bw: float = 52e12        # aggregate L2 bandwidth, B/s (≈3x LLC per paper)
    llc_bw: float = 17e12
    hbm_bw: float = 8e12
    peak_flops: float = 2.5e15  # BF16 matrix peak (MI355X)

    @staticmethod
    def h100() -> "CacheHW":
        """The H100 SXM (80 GB HBM3): 132 SMs sharing one 50 MB L2 (no
        chiplets, so one cluster and no LLC level), 3.35 TB/s of HBM and
        989 TFLOP/s of dense bf16. The L2 rate is an estimate (about 3.5x
        HBM, NVIDIA's Hopper tuning guide gives no figure); it ranks
        windows, it is no measurement."""
        return CacheHW(n_clusters=1, executors_per_cluster=132,
                       l2_bytes=50 * 2**20, llc_bytes=0, l2_bw=12e12,
                       llc_bw=0.0, hbm_bw=3.35e12, peak_flops=989e12)


class _LRU:
    __slots__ = ("cap", "used", "store")

    def __init__(self, cap_bytes: int):
        self.cap = cap_bytes
        self.used = 0
        self.store: OrderedDict = OrderedDict()

    def access(self, key, nbytes: int) -> bool:
        """Touch ``key``; returns True on hit. Inserts (with eviction) on miss."""
        if key in self.store:
            self.store.move_to_end(key)
            return True
        while self.used + nbytes > self.cap and self.store:
            _, old = self.store.popitem(last=False)
            self.used -= old
        if nbytes <= self.cap:
            self.store[key] = nbytes
            self.used += nbytes
        return False


@dataclasses.dataclass
class SimResult:
    l2_hit: float
    llc_hit: float
    effective_bw: float
    total_bytes_requested: int
    hbm_bytes: int
    modeled_time_s: float
    modeled_tflops: float


def simulate_gemm_schedule(cfg: SwizzleConfig, *, m: int, n: int, k: int,
                           block_m: int, block_n: int, block_k: int,
                           dtype_bytes: int = 2,
                           hw: CacheHW = CacheHW()) -> SimResult:
    """Run the block schedule through the cache hierarchy (paper Tab. 4)."""
    num_rows, num_cols = m // block_m, n // block_n
    nk = max(1, k // block_k)
    order = schedule_order(cfg, num_rows, num_cols)

    a_tile = block_m * block_k * dtype_bytes
    b_tile = block_k * block_n * dtype_bytes

    l2s = [_LRU(hw.l2_bytes) for _ in range(hw.n_clusters)]
    llc = _LRU(hw.llc_bytes)

    n_exec = hw.n_clusters * hw.executors_per_cluster
    l2_hits = llc_hits = requests = 0
    hbm_bytes = 0
    total_bytes = 0

    nblocks = len(order)
    for start in range(0, nblocks, n_exec):
        wave = order[start:start + n_exec]
        # Executors in a wave run concurrently and advance their k-loops in
        # rough lockstep, so tile requests interleave k-step-by-k-step (this
        # is what makes same-row/col blocks on one cluster share panels).
        for kk in range(nk):
            # hardware dispatches round-robin across clusters (paper §3.4)
            for slot, (bi, bj) in enumerate(wave):
                cluster = slot % hw.n_clusters
                for key, nbytes in ((("A", int(bi), kk), a_tile),
                                    (("B", kk, int(bj)), b_tile)):
                    requests += 1
                    total_bytes += nbytes
                    if l2s[cluster].access(key, nbytes):
                        l2_hits += 1
                        continue
                    if llc.access(key, nbytes):
                        llc_hits += 1
                        continue
                    hbm_bytes += nbytes

    l2_rate = l2_hits / requests
    llc_rate = llc_hits / requests
    miss_rate = 1.0 - l2_rate - llc_rate
    eff_bw = hw.l2_bw * l2_rate + hw.llc_bw * llc_rate + hw.hbm_bw * miss_rate
    flops = 2.0 * m * n * k
    time_s = max(total_bytes / eff_bw, flops / hw.peak_flops)
    return SimResult(l2_rate, llc_rate, eff_bw, total_bytes, hbm_bytes,
                     time_s, flops / time_s / 1e12)


def sweep_schedules(m, n, k, block_m, block_n, block_k,
                    windows=(1, 4, 5, 7, 8), chunks=(8, 25, 64, 216),
                    hw: CacheHW = CacheHW()):
    """Sweep (W, C) like the paper's Tab. 4 and return scored configs."""
    results = []
    base = simulate_gemm_schedule(
        SwizzleConfig(enable_chiplet=False, enable_window=False),
        m=m, n=n, k=k, block_m=block_m, block_n=block_n, block_k=block_k, hw=hw)
    results.append(("row-major", base))
    for w in windows:
        for c in chunks:
            cfg = SwizzleConfig(window=w, chunk=c, n_xcd=hw.n_clusters)
            r = simulate_gemm_schedule(cfg, m=m, n=n, k=k, block_m=block_m,
                                       block_n=block_n, block_k=block_k, hw=hw)
            results.append((f"XCD(W{w}/C{c})", r))
    return results
