"""H100 roofline constants and the analytic models the autotuner consumes.

The reference's :class:`ChipSpec` holds a TPU v5e's rates; the port's holds
the H100 SXM's: 989 TFLOP/s of dense bf16 and 3.35 TB/s of HBM3 (NVIDIA's
H100 datasheet, the figures PERF.md's bounds use), NVLink 4's eighteen
links of 25 GB/s a direction. The coefficients a calibration can re-fit
(``calibrate.fit_chip``) keep the reference's names.

The byte models count the port's kernels, not the TPU's:

* a GEMM with a norm prologue runs a row pass that reads A and writes the
  normalised A and the row statistics, and the product reads the
  normalised A back (the TPU kernel keeps it in VMEM), once per launch;
* the GEMM backward runs three launches: an operand pass that reads the
  cotangent and the saved preactivations and writes g-bar and its
  transpose and A's transpose, then dA and dB (a norm prologue's transpose
  adds an fp32 scratch round trip of dA).

Where those counts flip a fusion decision against the reference's at a
model's shapes, ROADMAP's deliberate differences name the shape.
"""
from __future__ import annotations

import dataclasses

from . import tiles


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Roofline constants; every coefficient ``calibrate.fit_chip`` can
    re-fit keeps the reference's name. ``ici_*`` are NVLink here."""

    name: str = "h100"
    peak_flops_bf16: float = 989e12      # dense bf16 tensor-core FLOP/s
    hbm_bw: float = 3.35e12              # B/s, HBM3
    ici_bw_per_link: float = 25e9        # B/s a direction per NVLink 4 link
    ici_links: int = 18
    smem_bytes: int = tiles.SMEM_PER_BLOCK
    sms: int = tiles.SMS
    l2_bytes: int = tiles.L2_BYTES
    # --- calibratable coefficients ---
    vector_flops: float = 0.0            # 0 -> peak_flops_bf16 / 16
    step_overhead_s: float = 5e-7        # fixed cost of one work item
    decode_saturation_steps: int = 2 * tiles.SMS   # blocks that fill the card

    def peak_flops(self, dtype_bytes: int = 2) -> float:
        # Hopper tensor cores: fp8 2x bf16; fp32 runs as tf32 at 1/2
        if dtype_bytes == 1:
            return 2 * self.peak_flops_bf16
        if dtype_bytes == 4:
            return self.peak_flops_bf16 / 2
        return self.peak_flops_bf16

    def vector_throughput(self) -> float:
        """Elementwise FLOP/s (softmax and norm work on the CUDA cores)."""
        return self.vector_flops or self.peak_flops_bf16 / 16


H100 = ChipSpec()


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self) -> float:
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0


def roofline(flops: float, hbm_bytes: float, collective_bytes: float,
             *, n_chips: int, chip: ChipSpec = H100,
             dtype_bytes: int = 2) -> RooflineTerms:
    compute = flops / (n_chips * chip.peak_flops(dtype_bytes))
    memory = hbm_bytes / (n_chips * chip.hbm_bw)
    coll = collective_bytes / (n_chips * chip.ici_bw_per_link * chip.ici_links)
    return RooflineTerms(compute, memory, coll)


# ---------------------------------------------------------------------------
# The GEMM mainloop: waves of persistent work items
# ---------------------------------------------------------------------------

COLUMN_COST = {256: 1.0, 128: 1.15, 64: 1.5}


def gemm_step_model(*, m: int, n: int, k: int, block_n: int, splits: int,
                    gate: bool = False, dtype_bytes: int = 2,
                    chip: ChipSpec = H100) -> dict:
    """One launch of the GEMM mainloop at tile width ``block_n`` and
    ``splits`` contraction splits: work items (tiles x splits) in waves
    over the SMs, each a BM x BN x (K / splits) product at the tensor
    cores' rate derated by the narrow tile's dearer columns, the operand
    bytes streamed once and the split partials written and read back."""
    bm, bk = tiles.GEMM_BM, tiles.GEMM_BK
    tile_out = block_n // 2 if gate else block_n
    n_tiles = -(-m // bm) * -(-n // tile_out)
    items = n_tiles * splits
    waves = -(-items // chip.sms)
    stages = -(-k // bk)
    item_flops = 2.0 * bm * block_n * (-(-stages // splits)) * bk
    compute_s = (waves * item_flops * COLUMN_COST.get(block_n, 1.0)
                 / (chip.peak_flops(dtype_bytes) / chip.sms))
    operand = (m * k + k * n * (2 if gate else 1) + m * n) * dtype_bytes
    partials = 2 * splits * m * n * 4 if splits > 1 else 0
    memory_s = (operand + partials) / chip.hbm_bw
    time_s = max(compute_s, memory_s) + waves * chip.step_overhead_s
    return dict(block=(bm, block_n, bk), splits=splits, items=items,
                waves=waves, compute_s=compute_s, memory_s=memory_s,
                dma_bytes=int(operand + partials), time_s=time_s,
                bound="compute" if compute_s >= memory_s else "memory")


def decode_step_model(*, batch: int, kv_heads: int, group: int,
                      kv_len: int, head_dim: int, block_kv: int,
                      dtype_bytes: int = 2, units: int | None = None,
                      chip: ChipSpec = H100) -> dict:
    """One split-KV decode launch: ``units`` (batch x kv heads x row tiles)
    each walking its keys in splits of ``block_kv``; bandwidth-bound, the
    card saturated at ``decode_saturation_steps`` blocks; each split beyond
    the first writes fp32 partials that the launch merges."""
    units = units or batch * kv_heads
    n_splits = max(1, -(-kv_len // block_kv))
    n_steps = units * n_splits
    kv_bytes = 2 * batch * kv_heads * kv_len * head_dim * dtype_bytes
    partial_bytes = (units * n_splits * (group * head_dim + 2 * group) * 4
                     if n_splits > 1 else 0)
    qo_bytes = 2 * batch * kv_heads * group * head_dim * dtype_bytes
    util = min(1.0, n_steps / chip.decode_saturation_steps)
    stream_s = kv_bytes / (chip.hbm_bw * util)
    total = (stream_s + (qo_bytes + 2 * partial_bytes) / chip.hbm_bw
             + n_splits * chip.step_overhead_s)
    flops = 4.0 * batch * kv_heads * group * kv_len * head_dim
    return dict(block_kv=block_kv, n_splits=n_splits, n_steps=n_steps,
                kv_bytes=kv_bytes, partial_bytes=partial_bytes,
                utilization=util, time_s=total,
                achieved_bw=kv_bytes / total if total else 0.0,
                modeled_tflops=flops / total / 1e12 if total else 0.0,
                bound="memory")


# ---------------------------------------------------------------------------
# Chain models: fused (the port's kernels) vs unfused (the plain chain)
# ---------------------------------------------------------------------------

def _chain_dict(dma_bytes: float, flops: float, fused: bool,
                dtype_bytes: int, chip: ChipSpec) -> dict:
    compute_s = flops / chip.peak_flops(dtype_bytes)
    memory_s = dma_bytes / chip.hbm_bw
    return dict(dma_bytes=int(dma_bytes), flops=flops, fused=fused,
                compute_s=compute_s, memory_s=memory_s,
                time_s=max(compute_s, memory_s),
                bound="compute" if compute_s >= memory_s else "memory")


def _prenorm_vec_bytes(d: int, prenorm: str, dtype_bytes: int) -> int:
    if prenorm == "none":
        return 0
    return d * dtype_bytes * (2 if prenorm == "layernorm" else 1)


def _row_pass_bytes(t: int, d: int, prenorm: str, dtype_bytes: int) -> int:
    """The norm prologue's row pass and the product's read of its output:
    read A, write the normalised A and the statistics, read it back."""
    if prenorm == "none":
        return 0
    stats = t * 4 * (2 if prenorm == "layernorm" else 1)
    return 2 * t * d * dtype_bytes + stats


def mlp_chain_model(*, tokens: int, d_model: int, d_ff: int,
                    dtype_bytes: int = 2, gated: bool = True,
                    residual: bool = True, prenorm: str = "none",
                    fused: bool = True, chip: ChipSpec = H100) -> dict:
    """[pre-norm +] up-projection(s) + activation [+ gating] + down [+
    scaled residual]. fused: one up launch (the dual-output gated GEMM)
    whose store runs the activation, with the norm's row pass in front;
    one down launch whose store adds the residual. unfused: the plain
    chain, every op re-reading and re-writing its activations."""
    t, d, f = tokens, d_model, d_ff
    act_td = t * d * dtype_bytes
    act_tf = t * f * dtype_bytes
    w_up = d * f * dtype_bytes
    w_down = f * d * dtype_bytes
    n_up = 2 if gated else 1
    norm_vec = _prenorm_vec_bytes(d, prenorm, dtype_bytes)
    if fused:
        up = (act_td + n_up * w_up + act_tf + norm_vec
              + _row_pass_bytes(t, d, prenorm, dtype_bytes))
        down = act_tf + w_down + act_td + (act_td if residual else 0)
        total = up + down
    else:
        norm_pass = (2 * act_td + norm_vec) if prenorm != "none" else 0
        up = n_up * (act_td + w_up + act_tf)
        glu = (3 if gated else 2) * act_tf
        down = act_tf + w_down + act_td
        resid = 3 * act_td if residual else 0
        total = norm_pass + up + glu + down + resid
    flops = 2.0 * t * f * d * (n_up + 1)
    if prenorm != "none":
        flops += 8.0 * t * d
    return _chain_dict(total, flops, fused, dtype_bytes, chip)


def qkv_rope_chain_model(*, tokens: int, d_model: int, num_heads: int,
                         num_kv_heads: int, head_dim: int,
                         dtype_bytes: int = 2, prenorm: str = "none",
                         rope: bool = True, fused: bool = True,
                         chip: ChipSpec = H100) -> dict:
    """[pre-norm +] the QKV projections [-> RoPE]. fused: the packed q|k
    launch (RoPE in its store, the tables streamed) and the v launch, each
    with its own row pass when the norm folds in. unfused: the standalone
    norm, the projections and a RoPE pass over q and k (``rope=False``:
    the packed two-GEMM plain path, no tables)."""
    t = tokens
    nq = num_heads * head_dim
    nkv = num_kv_heads * head_dim
    x_read = t * d_model * dtype_bytes
    w = d_model * (nq + 2 * nkv) * dtype_bytes
    qkv_write = t * (nq + 2 * nkv) * dtype_bytes
    tables = (2 * t * head_dim * 4) if rope else 0
    norm_vec = _prenorm_vec_bytes(d_model, prenorm, dtype_bytes)
    if fused:
        total = (2 * x_read + w + qkv_write + tables + 2 * norm_vec
                 + 2 * _row_pass_bytes(t, d_model, prenorm, dtype_bytes))
    else:
        norm_pass = (2 * x_read + norm_vec) if prenorm != "none" else 0
        rope_rw = 2 * t * (nq + nkv) * dtype_bytes if rope else 0
        n_reads = 3 if rope else 2
        total = norm_pass + n_reads * x_read + w + qkv_write + tables + rope_rw
    flops = 2.0 * t * d_model * (nq + 2 * nkv)
    if prenorm != "none":
        flops += 8.0 * tokens * d_model * (2 if fused else 1)
    return _chain_dict(total, flops, fused, dtype_bytes, chip)


def gemm_bwd_kernel_bytes(*, m: int, k: int, n: int, dtype_bytes: int = 2,
                          n_saved: int = 0, gated: bool = False,
                          prenorm: str = "none") -> int:
    """The three backward launches of one forward GEMM (m, k) @ (k, n'):
    the operand pass (read g and the saved preactivations and A, write
    g-bar, its transpose and A's transpose), dA (read g-bar and the
    weights, write dA; a norm's transpose writes and reads an fp32 dA and
    reads A) and dB (read both transposes, write dB)."""
    db_ = dtype_bytes
    n2 = 2 * n if gated else n
    a_b, g_b = m * k * db_, m * n * db_
    gbar = m * n2 * db_
    w_b = k * n2 * db_
    operand = g_b + n_saved * g_b + a_b + 2 * gbar + a_b
    da = gbar + w_b + a_b
    if prenorm != "none":
        da += 2 * m * k * 4 + a_b
    db = a_b + gbar + w_b
    return operand + da + db


def mlp_chain_bwd_model(*, tokens: int, d_model: int, d_ff: int,
                        dtype_bytes: int = 2, gated: bool = True,
                        residual: bool = True, prenorm: str = "none",
                        fused: bool = True, chip: ChipSpec = H100) -> dict:
    """Backward of the MLP chain. fused: the forward saves the activation's
    inputs (bf16), then each GEMM's three backward launches
    (:func:`gemm_bwd_kernel_bytes`); the residual's grad is the identity.
    unfused: the plain chain's autograd, its forward re-run."""
    t, d, f = tokens, d_model, d_ff
    act_td = t * d * dtype_bytes
    act_tf = t * f * dtype_bytes
    w_up = d * f * dtype_bytes
    w_down = f * d * dtype_bytes
    n_up = 2 if gated else 1
    norm_vec = _prenorm_vec_bytes(d, prenorm, dtype_bytes)
    if fused:
        saves = n_up * act_tf
        down = gemm_bwd_kernel_bytes(m=t, k=f, n=d, dtype_bytes=dtype_bytes)
        up = gemm_bwd_kernel_bytes(m=t, k=d, n=f, dtype_bytes=dtype_bytes,
                                   n_saved=n_up, gated=gated,
                                   prenorm=prenorm) + norm_vec
        total = saves + down + up
    else:
        recompute = mlp_chain_model(
            tokens=t, d_model=d, d_ff=f, dtype_bytes=dtype_bytes,
            gated=gated, residual=residual, prenorm=prenorm, fused=False,
            chip=chip)["dma_bytes"]
        resid_b = 2 * act_td if residual else 0
        down_b = (act_td + w_down + act_tf) + (act_tf + act_td + w_down)
        glu_b = (5 if gated else 3) * act_tf
        up_b = n_up * (act_tf + w_up + act_td) + n_up * (act_td + act_tf + w_up)
        norm_b = (3 * act_td + norm_vec) if prenorm != "none" else 0
        total = recompute + resid_b + down_b + glu_b + up_b + norm_b
    flops = 2 * 2.0 * t * f * d * (n_up + 1)
    if not fused:
        flops *= 1.5
    if prenorm != "none":
        flops += 8.0 * t * d
    return _chain_dict(total, flops, fused, dtype_bytes, chip)


def qkv_rope_chain_bwd_model(*, tokens: int, d_model: int, num_heads: int,
                             num_kv_heads: int, head_dim: int,
                             dtype_bytes: int = 2, prenorm: str = "none",
                             rope: bool = True, fused: bool = True,
                             chip: ChipSpec = H100) -> dict:
    """Backward of the QKV chain: fused, the q|k and v GEMMs' backward
    launches (the rope adjoint in the operand pass, its tables streamed)
    and dx summed; unfused, the plain chain's autograd."""
    t = tokens
    nq = num_heads * head_dim
    nkv = num_kv_heads * head_dim
    x_b = t * d_model * dtype_bytes
    tables = (2 * t * head_dim * 4) if rope else 0
    norm_vec = _prenorm_vec_bytes(d_model, prenorm, dtype_bytes)
    if fused:
        qk = gemm_bwd_kernel_bytes(m=t, k=d_model, n=nq + nkv,
                                   dtype_bytes=dtype_bytes, prenorm=prenorm)
        v = gemm_bwd_kernel_bytes(m=t, k=d_model, n=nkv,
                                  dtype_bytes=dtype_bytes, prenorm=prenorm)
        total = qk + v + tables + 2 * norm_vec + 3 * x_b
    else:
        recompute = qkv_rope_chain_model(
            tokens=t, d_model=d_model, num_heads=num_heads,
            num_kv_heads=num_kv_heads, head_dim=head_dim,
            dtype_bytes=dtype_bytes, prenorm=prenorm, rope=rope,
            fused=False, chip=chip)["dma_bytes"]
        gqk_b = t * (nq + nkv) * dtype_bytes
        gv_b = t * nkv * dtype_bytes
        wqk_b = d_model * (nq + nkv) * dtype_bytes
        wv_b = d_model * nkv * dtype_bytes
        rope_b = (2 * t * (nq + nkv) * dtype_bytes + tables) if rope else 0
        gemm_b = (2 * (gqk_b + wqk_b + x_b) + 2 * (gv_b + wv_b + x_b))
        norm_b = (3 * x_b + norm_vec) if prenorm != "none" else 0
        total = recompute + rope_b + gemm_b + norm_b + 3 * x_b
    flops = 2 * 2.0 * t * d_model * (nq + 2 * nkv)
    if not fused:
        flops *= 1.5
    if prenorm != "none":
        flops += 8.0 * t * d_model
    return _chain_dict(total, flops, fused, dtype_bytes, chip)


def attention_chain_model(*, batch: int, heads: int, kv_heads: int,
                          seq_q: int, seq_kv: int, head_dim: int,
                          causal: bool = True, softcap: bool = False,
                          sink: bool = False, dtype_bytes: int = 2,
                          fused: bool = True, chip: ChipSpec = H100) -> dict:
    """The flash kernel (q, k, v and the output streamed once, the fp32 lse
    written) against the plain chain that writes the fp32 score matrix and
    reads it back per op (4 passes, 6 with a softcap)."""
    b, h, hkv = batch, heads, kv_heads
    kv_frac = 0.5 if causal else 1.0
    qo = 2 * b * h * seq_q * head_dim * dtype_bytes
    kv = 2 * b * hkv * seq_kv * head_dim * dtype_bytes
    lse = b * h * seq_q * 4
    sink_b = h * 4 if sink else 0
    flops = 4.0 * b * h * seq_q * seq_kv * head_dim * kv_frac
    if fused:
        total = qo + kv + lse + sink_b
    else:
        smat = b * h * seq_q * seq_kv * kv_frac * 4
        total = qo + kv + (6 if softcap else 4) * smat + sink_b
    return _chain_dict(total, flops, fused, dtype_bytes, chip)


def attention_chain_bwd_model(*, batch: int, heads: int, kv_heads: int,
                              seq_q: int, seq_kv: int, head_dim: int,
                              causal: bool = True, softcap: bool = False,
                              sink: bool = False, dtype_bytes: int = 2,
                              fused: bool = True,
                              chip: ChipSpec = H100) -> dict:
    """The flash backward (delta, then one kernel for dq and dk/dv, the GQA
    group summed in the kernel) against the plain chain's autograd."""
    b, h, hkv = batch, heads, kv_heads
    kv_frac = 0.5 if causal else 1.0
    db = dtype_bytes
    q_b = b * h * seq_q * head_dim * db
    kv_b = 2 * b * hkv * seq_kv * head_dim * db
    vec = b * h * seq_q * 4
    sink_b = h * 4 if sink else 0
    flops = 2.5 * 4.0 * b * h * seq_q * seq_kv * head_dim * kv_frac
    if fused:
        delta_pass = 2 * q_b + vec
        main = 3 * q_b + kv_b + 2 * vec + kv_b + b * h * seq_q * head_dim * 4
        total = delta_pass + main + sink_b
    else:
        recompute = attention_chain_model(
            batch=b, heads=h, kv_heads=hkv, seq_q=seq_q, seq_kv=seq_kv,
            head_dim=head_dim, causal=causal, softcap=softcap, sink=sink,
            dtype_bytes=db, fused=False, chip=chip)["dma_bytes"]
        smat = b * h * seq_q * seq_kv * kv_frac * 4
        total = (recompute + (8 if softcap else 6) * smat + 2 * q_b + kv_b
                 + q_b + kv_b)
        flops *= 1.5
    return _chain_dict(total, flops, fused, dtype_bytes, chip)


# ---------------------------------------------------------------------------
# gemm_fused(bwd_mode="auto"): the kernel backward or the oracle's autograd
# ---------------------------------------------------------------------------

# Seconds charged per byte parked in HBM between forward and backward,
# relative to streaming it once (the reference's factor).
PEAK_RESIDENCY_FACTOR = 4.0


def gemm_bwd_route_model(*, m: int, n: int, k: int, dtype_bytes: int = 2,
                         n_saved: int = 0, preact_bytes: int = 2,
                         gated: bool = False, prenorm: bool = False,
                         chip: ChipSpec = H100) -> dict:
    """The kernel backward (:func:`gemm_bwd_kernel_bytes`, plus the saved
    preactivations' write and their residency) against the oracle's
    autograd (the forward re-run, each op's transpose materialised)."""
    a_b = m * k * dtype_bytes
    g_b = m * n * dtype_bytes
    w_b = k * n * dtype_bytes * (2 if gated else 1)
    save_b = n_saved * m * n * preact_bytes
    kernel_bytes = save_b + gemm_bwd_kernel_bytes(
        m=m, k=k, n=n, dtype_bytes=dtype_bytes, n_saved=n_saved, gated=gated,
        prenorm="rmsnorm" if prenorm else "none")
    kernel_flops = (2 if gated else 1) * 4.0 * m * n * k
    n_up = 2 if gated else 1
    recompute_b = a_b + w_b + (n_up + 2) * g_b
    bwd_gemms_b = (g_b + w_b + a_b) + (a_b + g_b + w_b)
    chain_b = 3 * n_up * g_b
    ref_bytes = recompute_b + bwd_gemms_b + chain_b
    ref_flops = 1.5 * kernel_flops
    pf = chip.peak_flops(dtype_bytes)
    kernel_t = max(kernel_flops / pf, kernel_bytes / chip.hbm_bw)
    ref_t = max(ref_flops / pf, ref_bytes / chip.hbm_bw)
    residency_s = PEAK_RESIDENCY_FACTOR * save_b / chip.hbm_bw
    kernel_score = kernel_t + residency_s
    return dict(kernel_bytes=int(kernel_bytes), reference_bytes=int(ref_bytes),
                kernel_flops=kernel_flops, reference_flops=ref_flops,
                kernel_time_s=kernel_t, reference_time_s=ref_t,
                peak_save_bytes=int(save_b), residency_s=residency_s,
                kernel_score=kernel_score, reference_score=ref_t,
                route="kernel" if kernel_score <= ref_t else "reference")


# ---------------------------------------------------------------------------
# Collective chains: the NVLink term
# ---------------------------------------------------------------------------

def collective_wire_bytes(kind: str, nbytes: float, n_shards: int) -> float:
    """Per-rank wire bytes of one ring collective over ``n_shards``."""
    if n_shards <= 1 or kind == "none":
        return 0.0
    frac = (n_shards - 1) / n_shards
    if kind == "all_reduce":
        return 2.0 * nbytes * frac
    if kind in ("all_gather", "reduce_scatter", "all_to_all"):
        return nbytes * frac
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_model(kind: str, nbytes: float, *, n_shards: int,
                     chip: ChipSpec = H100) -> dict:
    wire = collective_wire_bytes(kind, nbytes, n_shards)
    bw = chip.ici_bw_per_link * chip.ici_links
    return dict(kind=kind, wire_bytes=int(wire), collective_s=wire / bw,
                steps=max(0, n_shards - 1))


def hbm_equivalent_bytes(wire_bytes: float, chip: ChipSpec = H100) -> float:
    """Wire bytes in HBM-time-equivalent bytes, so a sharded plan's score
    stays bytes."""
    return wire_bytes * chip.hbm_bw / (chip.ici_bw_per_link * chip.ici_links)


def collective_chain_model(chain: dict, *, collective: str, nbytes: float,
                           n_shards: int, chip: ChipSpec = H100) -> dict:
    """A chain dict with one collective's term attached (the reference's
    form): ``dma_bytes`` carries the wire bytes in HBM-equivalent units."""
    coll = collective_model(collective, nbytes, n_shards=n_shards, chip=chip)
    d = dict(chain)
    cs = coll["collective_s"]
    chain_s = d["time_s"]
    d.update(collective=collective, collective_bytes=coll["wire_bytes"],
             collective_s=cs, serialized_s=chain_s + cs,
             overlapped_s=max(chain_s, cs),
             overlap_fraction=(min(chain_s, cs) / cs) if cs > 0 else 0.0,
             hbm_dma_bytes=d["dma_bytes"],
             dma_bytes=int(d["dma_bytes"]
                           + hbm_equivalent_bytes(coll["wire_bytes"], chip)),
             time_s=max(chain_s, cs))
    return d


def collective_gemm_model(*, m: int, n: int, k: int, n_shards: int,
                          dtype_bytes: int = 2, variant: str = "all_gather",
                          fused: bool = True, chip: ChipSpec = H100) -> dict:
    """The ring collective GEMM (``kernels/gemm/collective.py``, 'ring')
    against the gather plan ('gather'). (m, n, k) is the full GEMM.

    ring: one ``gemm_fused`` launch a panel, S of them, each reading its
    panel and the whole local weight (so the weight streams S times), the
    hops overlapped with the panels (reduce_scatter hands fp32
    accumulator panels round the ring, written and read at each step).
    gather: the collective first, its result written to HBM and read back
    by one launch."""
    s = max(1, n_shards)
    flops = 2.0 * m * n * k
    if variant == "all_gather":
        moved = float(m * k) * dtype_bytes
        ring_bytes = (m * k + s * k * n + m * n) * dtype_bytes
    elif variant == "reduce_scatter":
        moved = float(m * n) * 4
        ring_bytes = (m * k + s * k * n / s + m * n) * dtype_bytes \
            + 2.0 * m * n * 4 * (s - 1) / s
    else:
        raise ValueError(f"unknown collective-GEMM variant {variant!r}")
    gemm_bytes = float(m * k + k * n + m * n) * dtype_bytes
    coll = collective_model(variant, moved, n_shards=s, chip=chip)
    cs = coll["collective_s"]
    wire_hbm = hbm_equivalent_bytes(coll["wire_bytes"], chip)
    if fused:
        chain = _chain_dict(ring_bytes, flops, True, dtype_bytes, chip)
        step_s = chain["time_s"] / s
        hop_s = cs / max(1, s - 1) if s > 1 else 0.0
        overlapped = step_s + (s - 1) * max(step_s, hop_s)
        serialized = chain["time_s"] + cs
        hidden = max(0.0, serialized - overlapped)
        chain.update(collective=variant, collective_bytes=coll["wire_bytes"],
                     collective_s=cs, serialized_s=serialized,
                     overlapped_s=overlapped,
                     overlap_fraction=min(1.0, hidden / cs) if cs > 0 else 0.0,
                     hbm_dma_bytes=chain["dma_bytes"],
                     dma_bytes=int(ring_bytes + wire_hbm), time_s=overlapped,
                     ring_steps=s)
        return chain
    chain = _chain_dict(gemm_bytes + 2.0 * moved, flops, False, dtype_bytes,
                        chip)
    chain.update(collective=variant, collective_bytes=coll["wire_bytes"],
                 collective_s=cs, serialized_s=chain["time_s"] + cs,
                 overlapped_s=chain["time_s"] + cs, overlap_fraction=0.0,
                 hbm_dma_bytes=chain["dma_bytes"],
                 dma_bytes=int(chain["dma_bytes"] + wire_hbm),
                 time_s=chain["time_s"] + cs, ring_steps=1)
    return chain

