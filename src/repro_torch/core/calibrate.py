"""Measured calibration of the autotuner (the reference's ``core/calibrate.py``).

1. **Measure**: :func:`calibrate` times the ranked candidates of each cell
   (an :class:`~.autotune.OpSignature`). On the card the measurement is
   wall-clock: :class:`CardMeasure` launches each candidate's kernel on
   seeded operands and times it with :class:`Timer` (a CUDA graph replayed
   between two events, the L2 scrubbed before each replay). Without a card
   :class:`CalibrationRig` prices each candidate's geometry
   (:func:`policy_features`) with constants of its own, as the reference's
   proxy does.
2. **Fit**: :func:`fit_chip` recovers the :class:`~.perf_model.ChipSpec`
   coefficients by least squares over the sweep.
3. **Persist**: the report is an installable pretuned table in the
   reference's schema (``schema_version``, ``arch``, ``cells``, ``fusion``,
   ``chip``, ``fit``, ``seed``); ``launch/calibrate.py`` writes it and
   ``configs/pretuned/`` ships one per arch.
4. **Gate**: :func:`check_drift` compares the analytic ranking with the
   measured one (top-1 within a tolerance, Spearman per op family).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import zlib
from typing import Callable, Iterable, Optional

import numpy as np

from repro_torch import obs

from . import autotune
from . import perf_model as pm
from .autotune import OpSignature
from .policy import KernelPolicy, policy_spec

SCHEMA_VERSION = autotune.PRETUNED_SCHEMA_VERSION
_DTYPE_BYTES = autotune._DTYPE_BYTES


# ---------------------------------------------------------------------------
# Proxy counters: the geometry of one launch
# ---------------------------------------------------------------------------

def policy_features(sig: OpSignature, policy: KernelPolicy) -> dict:
    """What a counter would report of one (sig, policy) launch, from its
    geometry alone, in the terms of the analytic model
    (``autotune.score_policy``), as the reference's: ``mxu_flops`` the
    tensor-core work of the work items as launched (ragged tiles and the
    narrow tiles' dearer columns included), ``vector_ops``, ``dma_bytes``
    (the operands streamed once and the split partials) and ``grid_steps``
    (the waves of work items over the SMs, each paying the fixed cost).
    Decode cells split out ``kv_bytes`` (the stream that rides the
    saturation ramp), ``other_bytes`` and ``blocks`` (what fills the
    card); their ``grid_steps`` are the splits a block walks in turn."""
    db = _DTYPE_BYTES.get(sig.dtype, 2)
    chip = pm.H100
    if sig.op in ("gemm", "gemm_bwd"):
        m, n, k = sig.shape
        gate = sig.op == "gemm" and bool(getattr(sig.epilogue, "gate", False))
        step = pm.gemm_step_model(m=m, n=n, k=k, block_n=policy.block_n,
                                  splits=policy.splits, gate=gate,
                                  dtype_bytes=db, chip=chip)
        flops = step["compute_s"] * chip.peak_flops(db)
        return dict(mxu_flops=flops, vector_ops=0.0,
                    dma_bytes=step["dma_bytes"], grid_steps=step["waves"])
    if sig.op in ("attention_fwd", "attention_bwd"):
        b, h, sq, skv, d = sig.shape
        kv_frac = 0.5 if sig.causal else 1.0
        flops = 4.0 * b * h * sq * skv * d * kv_frac
        traffic = 2 * b * h * (sq + skv) * d * db
        if sig.op == "attention_bwd":
            flops *= 2.5
            traffic *= 2
        return dict(mxu_flops=flops, vector_ops=5.0 * b * h * sq * skv * kv_frac,
                    dma_bytes=traffic,
                    grid_steps=b * h * -(-sq // policy.block_q))
    if sig.op == "attention_decode":
        b, hkv, g, skv, d = sig.shape
        ns = policy.splits
        units = autotune.decode_units(b, hkv, g, sig.q_tokens)
        kv_bytes = 2 * b * hkv * skv * d * db
        partial = units * ns * (g * d + 2 * g) * 4 if ns > 1 else 0
        other = 2 * partial + 2 * b * hkv * g * d * db
        return dict(mxu_flops=0.0, vector_ops=0.0,
                    dma_bytes=kv_bytes + other, grid_steps=ns,
                    blocks=units * ns, kv_bytes=kv_bytes, other_bytes=other)
    if sig.op == "fused_norm":
        rows, d = sig.shape
        return dict(mxu_flops=0.0, vector_ops=0.0, dma_bytes=4 * rows * d * db,
                    grid_steps=-(-rows // policy.block_rows))
    b, h, s, d = sig.shape   # rope
    return dict(mxu_flops=0.0, vector_ops=0.0,
                dma_bytes=b * h * s * d * (2 * db + 8),
                grid_steps=-(-b * h * s // policy.block_rows))


# ---------------------------------------------------------------------------
# Measurement: the proxy without a card, wall clock on it
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationRig:
    """A deterministic stand-in card for runs without CUDA: prices
    :func:`policy_features` with its own constants, the analytic H100's in
    the reference rig's ratios to its chip (a slightly slower, more
    overhead-prone card that fills later), ``jitter`` a seeded relative
    perturbation per (cell, candidate) keyed by content hash."""

    mxu_flops: float = 0.85 * 989e12
    vector_flops: float = 0.85 * 989e12 / 20.0
    hbm_bw: float = 0.9 * 3.35e12
    step_overhead_s: float = 1.3 * 5e-7
    decode_saturation_steps: int = 330
    jitter: float = 0.0
    seed: int = 0

    def time(self, sig: OpSignature, policy: KernelPolicy) -> float:
        f = policy_features(sig, policy)
        if sig.op == "attention_decode":
            util = min(1.0, f["blocks"] / self.decode_saturation_steps)
            t = (f["kv_bytes"] / (self.hbm_bw * util)
                 + f["other_bytes"] / self.hbm_bw
                 + f["grid_steps"] * self.step_overhead_s)
        else:
            compute = (f["mxu_flops"] / self.mxu_flops
                       + f["vector_ops"] / self.vector_flops)
            t = (max(compute, f["dma_bytes"] / self.hbm_bw)
                 + f["grid_steps"] * self.step_overhead_s)
        if self.jitter:
            key = (f"{self.seed}|{autotune.pretuned_cell_key(sig)}|"
                   f"{policy.block_m}x{policy.block_n}x{policy.block_k}"
                   f"s{policy.splits}w{policy.window}")
            u = (zlib.crc32(key.encode()) % 10000) / 10000.0 * 2.0 - 1.0
            t *= 1.0 + self.jitter * u
        return t

    def describe(self) -> dict:
        return {k: getattr(self, k) for k in
                ("mxu_flops", "vector_flops", "hbm_bw", "step_overhead_s",
                 "decode_saturation_steps", "jitter", "seed")}


class Timer:
    """Median device milliseconds of one call. The call is captured once in
    a CUDA graph and replayed between two CUDA events, so the time is the
    device's and not the Python wrapper's enqueue time. A 128 MiB buffer is
    rewritten before every replay: the 50 MB L2 starts cold, as it does for
    weights streamed once per layer, and the device is still busy with it
    while the host enqueues the replay. The time includes the replay's fixed
    cost (``floor``: a one-element fill) and the write-back of the dirty
    lines the scrub leaves in L2. With ``clean`` the scrub reads the buffer
    instead, so the L2 starts cold and clean."""

    def __init__(self, device, iters: int = 10, warmup: int = 2,
                 clean: bool = False):
        import torch

        self.scrub = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        self.iters, self.warmup, self.clean = iters, warmup, clean
        self._sum = torch.empty((), dtype=torch.int64, device=device)

    def _scrub(self):
        import torch

        if self.clean:
            torch.sum(self.scrub.view(torch.int64), dim=0, out=self._sum)
        else:
            self.scrub.zero_()

    def floor(self) -> float:
        """The time of a one-element fill: what any replayed call costs."""
        import torch

        one = torch.zeros(1, device=self.scrub.device)
        return self.ms(one.zero_)

    def ms(self, fn, stream=None) -> float:
        """``stream``: warm up and capture on it (the stream that autograd
        runs a recorded graph's backward on), else on a side stream."""
        import torch

        side = stream or torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(self.iters)]
        for start, end in ev:
            self._scrub()
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize()
        del graph
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def _gemm_operands(m, n, k, ep, pro, gen, dev):
    """Seeded bf16 operands of one forward GEMM of chain (ep, pro)."""
    import torch

    from repro_torch.kernels.rope import rope_tables

    bf = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf)

    kw = {}
    if ep is not None:
        if ep.gate:
            kw["b2"] = rnd(k, n, std=k ** -0.5)
        if ep.bias:
            kw["bias"] = rnd(n, std=0.1)
        if ep.residual:
            kw["residual"] = rnd(m, n)
        if ep.scale:
            kw["scale"] = 1.0
        if ep.rope:
            pos = torch.arange(m, device=dev) % 4096
            sin, cos = rope_tables(pos, ep.head_dim)
            kw["sin"], kw["cos"] = sin.contiguous(), cos.contiguous()
    if pro is not None:
        kw["gamma"] = (1.0 + rnd(k, std=0.1).float()).to(bf)
        if pro.beta:
            kw["beta"] = rnd(k, std=0.1)
    return rnd(m, k), rnd(k, n, std=k ** -0.5), kw


class CardMeasure:
    """The wall-clock ``measure_fn`` on the card: ``measure(sig, policy)``
    builds seeded operands for the cell once, launches the candidate's
    kernel and returns its :class:`Timer` time in seconds. ``launch(sig,
    policy)`` returns the launch's output (the checks hold it to the plain
    version and across windows)."""

    def __init__(self, device, *, seed: int = 0, timer: Optional[Timer] = None):
        import torch

        self.device = torch.device(device)
        self.seed = seed
        self.timer = timer or Timer(self.device)
        self._cells: dict = {}

    def operands(self, sig: OpSignature) -> dict:
        import torch

        key = autotune.pretuned_cell_key(sig) + f"|{sig.shape}"
        if key in self._cells:
            return self._cells[key]
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + zlib.crc32(key.encode()))
        ep, pro = sig.epilogue, sig.prologue
        if sig.op == "gemm":
            m, n, k = sig.shape
            a, b, kw = _gemm_operands(m, n, k, ep, pro, gen, self.device)
            cell = dict(a=a, b=b, kw=kw)
        elif sig.op == "gemm_bwd":
            cell = self._bwd_operands(sig, gen)
        elif sig.op == "attention_decode":
            b, hkv, g, skv, d = sig.shape
            bf = torch.bfloat16
            cell = dict(
                q=torch.randn((b, hkv * g, 1, d), generator=gen,
                              device=self.device).to(bf),
                k=torch.randn((b, hkv, skv, d), generator=gen,
                              device=self.device).to(bf),
                v=torch.randn((b, hkv, skv, d), generator=gen,
                              device=self.device).to(bf),
                lengths=torch.full((b,), skv, dtype=torch.int32,
                                   device=self.device))
        else:
            raise ValueError(f"no card measurement for op {sig.op!r}")
        self._cells[key] = cell
        return cell

    def _bwd_operands(self, sig, gen):
        import torch

        from repro_torch.kernels.gemm import ops
        from repro_torch.kernels.gemm.epilogue import EPILOGUE_NONE
        from repro_torch.kernels.gemm.prologue import PROLOGUE_NONE

        ep = sig.epilogue or EPILOGUE_NONE
        pro = sig.prologue or PROLOGUE_NONE
        if sig.variant == "da":
            m, k, n = sig.shape
        else:
            k, n2, m = sig.shape
            n = n2 // 2 if ep.gate else n2
        a, b, kw = _gemm_operands(m, n, k, sig.epilogue, sig.prologue, gen,
                                  self.device)
        _, stats, preacts = ops._forward(
            a, b, ep, pro, b2=kw.get("b2"), bias=kw.get("bias"),
            residual=kw.get("residual"), scale=kw.get("scale"),
            sin=kw.get("sin"), cos=kw.get("cos"), gamma=kw.get("gamma"),
            beta=kw.get("beta"), out_dtype=torch.bfloat16,
            save_preact=ops.kernel_saves(ep) > 0)
        g = torch.randn((m, n), generator=gen, device=self.device).to(
            torch.bfloat16)
        kw.pop("residual", None)
        return dict(a=a, b=b, g=g, kw=dict(kw, epilogue=ep, prologue=pro,
                                           rstd=stats,
                                           preacts=tuple(preacts)))

    def launch(self, sig: OpSignature, policy: KernelPolicy):
        return self._call(sig, policy)()

    def _call(self, sig, policy):
        import torch

        cell = self.operands(sig)
        if sig.op == "gemm":
            from repro_torch.kernels.gemm.ops import gemm_fused
            from repro_torch.kernels.gemm.epilogue import EPILOGUE_NONE
            from repro_torch.kernels.gemm.prologue import PROLOGUE_NONE

            ep = sig.epilogue or EPILOGUE_NONE
            pro = sig.prologue or PROLOGUE_NONE
            return lambda: gemm_fused(cell["a"], cell["b"], epilogue=ep,
                                      prologue=pro, policy=policy,
                                      **cell["kw"])
        if sig.op == "gemm_bwd":
            from repro_torch.kernels.gemm.backward import BwdLaunch

            key = "da_policy" if sig.variant == "da" else "db_policy"
            run = BwdLaunch(cell["a"], cell["b"], cell["g"], **cell["kw"],
                            **{key: policy})
            run.operand_pass()
            if sig.variant == "da":
                return lambda: run.da()[0]
            return lambda: torch.cat([t for t in run.db() if t is not None],
                                     dim=1)
        from repro_torch.kernels.attention.decode import attention_decode

        return lambda: attention_decode(cell["q"], cell["k"], cell["v"],
                                        cell["lengths"], policy=policy)

    def __call__(self, sig: OpSignature, policy: KernelPolicy) -> float:
        return self.timer.ms(self._call(sig, policy)) * 1e-3


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def default_sweep(smoke: bool = False, cfg=None, *, batch: int = 4,
                  prompt: int = 256, max_len: int = 296,
                  train_batch: int = 4, train_seq: int = 1024) -> list:
    """llama-1b's main-path cells (another config's with ``cfg``): its
    layer's four forward GEMMs at prefill (``batch`` x ``prompt`` tokens)
    and the decode step's up and down (``batch`` rows), the prefill up and
    down's backward (dA and dB) and the ring decode attention over
    ``max_len`` slots. The full sweep adds the training shapes (``train_batch``
    x ``train_seq``): the four forward GEMMs and every backward launch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.gemm.epilogue import Epilogue
    from repro_torch.kernels.gemm.prologue import norm_prologue

    cfg = cfg or get_config("llama-1b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    pro = norm_prologue(cfg.norm, beta=cfg.norm == "layernorm")
    up = Epilogue(activation="silu", gate=True)
    down = Epilogue(residual=True, scale=True)
    rope = Epilogue(rope=True, head_dim=hd)

    def layer(m):
        return [OpSignature("gemm", (m, (h + hkv) * hd, d), epilogue=rope,
                            prologue=pro),
                OpSignature("gemm", (m, hkv * hd, d), prologue=pro),
                OpSignature("gemm", (m, f, d), epilogue=up, prologue=pro),
                OpSignature("gemm", (m, d, f), epilogue=down)]

    def bwd(m, which):
        out = []
        for sig in which:
            mm, n, k = sig.shape
            n2 = 2 * n if getattr(sig.epilogue, "gate", False) else n
            out += [OpSignature("gemm_bwd", (mm, k, n), epilogue=sig.epilogue,
                                prologue=sig.prologue, variant="da"),
                    OpSignature("gemm_bwd", (k, n2, mm),
                                epilogue=sig.epilogue, prologue=sig.prologue,
                                variant="db")]
        return out

    pre = layer(batch * prompt)
    cells = pre + [OpSignature("gemm", (batch, f, d), epilogue=up,
                               prologue=pro),
                   OpSignature("gemm", (batch, d, f), epilogue=down)]
    cells += bwd(batch * prompt, pre[2:])
    cells.append(OpSignature("attention_decode",
                             (batch, hkv, h // hkv, max_len, hd)))
    if not smoke:
        train = layer(train_batch * train_seq)
        cells += train + bwd(train_batch * train_seq, train)
    return cells


def fusion_cells(cfg=None, *, batch: int = 4, prompt: int = 256) -> list:
    """The fusion decisions a table pins, at ``cfg``'s prefill shape
    (llama-1b's by default): the prenorm MLP forward and backward, the
    rope-fused QKV and the causal attention."""
    from repro_torch.configs import get_config

    cfg = cfg or get_config("llama-1b")
    t = batch * prompt
    gated = int(cfg.mlp_act in ("swiglu", "geglu"))
    return [
        ("mlp", (t, cfg.d_model, cfg.d_ff, gated), dict(prenorm=cfg.norm)),
        ("mlp", (t, cfg.d_model, cfg.d_ff, gated),
         dict(prenorm=cfg.norm, backward=True)),
        ("qkv_rope", (t, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim), dict(prenorm=cfg.norm)),
        ("attention", (batch, cfg.num_heads, cfg.num_kv_heads, prompt,
                       prompt, cfg.head_dim), dict(causal=True)),
    ]


# ---------------------------------------------------------------------------
# Coefficient fitting
# ---------------------------------------------------------------------------

def fit_chip(samples: list, decode_samples: list, *,
             arch: str = "cpu") -> tuple:
    """Least squares of t ~ F/peak + V/vec + B/bw + S*step over
    ``samples`` ((features, time_s) pairs), each coefficient falling back
    to the analytic H100's where the sweep does not constrain it (or gives
    a negative one); the decode ramp by 1-D search over
    ``decode_samples``. Returns (coefficients, fit info)."""
    defaults = dict(peak_flops_bf16=pm.H100.peak_flops_bf16,
                    vector_flops=pm.H100.peak_flops_bf16 / 16,
                    hbm_bw=pm.H100.hbm_bw,
                    step_overhead_s=pm.H100.step_overhead_s,
                    decode_saturation_steps=pm.H100.decode_saturation_steps)
    info: dict = {"n_samples": len(samples),
                  "n_decode_samples": len(decode_samples)}
    out = dict(defaults)
    if samples:
        a = np.array([[f["mxu_flops"], f["vector_ops"], f["dma_bytes"],
                       f["grid_steps"]] for f, _ in samples])
        t = np.array([v for _, v in samples])
        scale = np.where(np.abs(a).max(axis=0) > 0, np.abs(a).max(axis=0), 1)
        coef, residual, *_ = np.linalg.lstsq(a / scale, t, rcond=None)
        coef = coef / scale
        info["lstsq_residual"] = float(residual[0]) if len(residual) else 0.0
        names = ("peak_flops_bf16", "vector_flops", "hbm_bw",
                 "step_overhead_s")
        for i, name in enumerate(names):
            c = float(coef[i])
            constrained = bool(np.abs(a[:, i]).max() > 0)
            if not constrained or c <= 0:
                info[f"{name}_fallback"] = True
                continue
            out[name] = c if name == "step_overhead_s" else 1.0 / c
    if decode_samples:
        best = (math.inf, defaults["decode_saturation_steps"])
        for ramp in range(8, 8 * pm.H100.sms + 1, 8):
            sse = 0.0
            for f, v in decode_samples:
                util = min(1.0, f["blocks"] / ramp)
                pred = (f["kv_bytes"] / (out["hbm_bw"] * util)
                        + f["other_bytes"] / out["hbm_bw"]
                        + f["grid_steps"] * out["step_overhead_s"])
                sse += (pred - v) ** 2
            if sse < best[0]:
                best = (sse, ramp)
        out["decode_saturation_steps"] = best[1]
        info["decode_ramp_sse"] = best[0]
    out["name"] = f"{arch}_calibrated"
    return out, info


# ---------------------------------------------------------------------------
# The calibration run
# ---------------------------------------------------------------------------

def calibrate(cells: Optional[Iterable[OpSignature]] = None, *,
              rig: Optional[CalibrationRig] = None,
              measure_fn: Optional[Callable] = None, smoke: bool = False,
              top_k: int = 64, seed: int = 0, arch: Optional[str] = None,
              sms: Optional[int] = None, fusion: Optional[list] = None,
              metadata: Optional[dict] = None) -> dict:
    """Measure each cell's first ``top_k`` candidates by the analytic
    ranking (the hand-fitted plan is candidate 0) with ``measure_fn(sig,
    policy) -> seconds`` (the rig's proxy without one) and pin the measured
    winner; score the fusion cells once and pin their plans; fit the chip.
    The returned dict is both the drift report and the installable table.
    ``metadata`` (the card's name and power limit) joins the report."""
    arch = arch or autotune.default_arch()
    rig = rig or CalibrationRig(seed=seed)
    measure = measure_fn or rig.time
    cells = list(cells) if cells is not None else default_sweep(smoke=smoke)
    sms = sms or pm.H100.sms
    report: dict = {"schema_version": SCHEMA_VERSION, "arch": arch,
                    "seed": seed, "rig": rig.describe(),
                    "cells": {}, "fusion": {}}
    if metadata:
        report["metadata"] = dict(metadata)
    samples: list = []
    decode_samples: list = []
    for sig in sorted(cells, key=lambda s: autotune.pretuned_cell_key(s)):
        ranked = autotune.ranked_candidates(sig, pm.H100, sms)[:top_k]
        if not ranked:
            continue
        rows = []
        for pol in ranked:
            t = float(measure(sig, pol))
            score = autotune.score_policy(sig, pol, pm.H100)
            feats = policy_features(sig, pol)
            rows.append({"blocks": [pol.block_m, pol.block_n, pol.block_k],
                         "n_buffers": pol.n_buffers,
                         "splits": pol.splits, "window": pol.window,
                         "schedule": pol.schedule.name,
                         "spec": policy_spec(pol),
                         "measured_time_s": t,
                         "analytic_time_s": score.time_s,
                         "dma_bytes": score.dma_bytes})
            (decode_samples if sig.op == "attention_decode"
             else samples).append((feats, t))
        win_i = min(range(len(rows)),
                    key=lambda i: (rows[i]["measured_time_s"], i))
        key = autotune.pretuned_cell_key(sig)
        report["cells"][key] = {
            "sig": sig_to_json(sig),
            "policy": rows[win_i]["spec"],
            "measured_time_s": rows[win_i]["measured_time_s"],
            "analytic_time_s": rows[win_i]["analytic_time_s"],
            "analytic_best_time_s": rows[0]["analytic_time_s"],
            "analytic_pick_time_s": rows[0]["measured_time_s"],
            "candidates": [{k2: v for k2, v in r.items() if k2 != "spec"}
                           for r in rows]}
        obs.incr("calibrate.cells")

    for kind, shape, kw in (fusion if fusion is not None else fusion_cells()):
        tokens = 1 << max(0, (shape[0] - 1).bit_length())
        plan = autotune.select_fusion(kind, shape, "bfloat16", chip=pm.H100,
                                      **kw)
        fkey = autotune.pretuned_fusion_key(
            kind, (tokens,) + tuple(shape[1:]), "bfloat16",
            residual=kw.get("residual", True),
            prenorm=kw.get("prenorm", "none"),
            backward=kw.get("backward", False),
            causal=kw.get("causal", False),
            softcap=kw.get("softcap", False), sink=kw.get("sink", False),
            shard=kw.get("shard"))
        report["fusion"][fkey] = {
            "kind": kind, "shape": list(shape),
            "kwargs": {k2: (autotune._shard_str(v) if k2 == "shard" else v)
                       for k2, v in kw.items()},
            "plan": {k2: v for k2, v in plan.items()
                     if k2 not in ("fused", "unfused")}}

    chip, fit_info = fit_chip(sorted(samples, key=lambda s: s[1]),
                              sorted(decode_samples, key=lambda s: s[1]),
                              arch=arch)
    report["chip"] = chip
    report["fit"] = fit_info
    return report


def sig_to_json(sig: OpSignature) -> dict:
    out = {"op": sig.op, "shape": list(sig.shape), "dtype": sig.dtype,
           "causal": sig.causal,
           "epilogue": autotune._chain_str(sig.epilogue),
           "prologue": autotune._chain_str(sig.prologue),
           "variant": sig.variant,
           "shard": autotune._shard_str(sig.shard)}
    if sig.q_tokens != 1:
        out["q_tokens"] = sig.q_tokens
    return out


def save_report(report: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# The drift gate (the reference's, pure JSON math)
# ---------------------------------------------------------------------------

def spearman(xs, ys) -> float:
    """Spearman rank correlation with average-rank tie handling."""
    def ranks(v):
        v = np.asarray(v, dtype=float)
        order = np.argsort(v, kind="stable")
        r = np.empty(len(v))
        r[order] = np.arange(len(v), dtype=float)
        for val in np.unique(v):
            mask = v == val
            r[mask] = r[mask].mean()
        return r

    rx, ry = ranks(xs), ranks(ys)
    sx, sy = rx.std(), ry.std()
    if sx == 0 or sy == 0:
        return 1.0
    return float(((rx - rx.mean()) * (ry - ry.mean())).mean() / (sx * sy))


def check_drift(report: dict, *, top1_tol: float = 0.05,
                min_spearman: float = 0.8) -> dict:
    """Does the analytic ranking agree with the measured one? Per cell the
    measured winner's analytic time within ``top1_tol`` of the analytic
    best; per op family the mean Spearman correlation over the measured
    candidates at least ``min_spearman``."""
    fams: dict = {}
    violations = []
    for key, cell in sorted(report.get("cells", {}).items()):
        op = cell["sig"]["op"]
        f = fams.setdefault(op, {"cells": 0, "top1_ok": 0, "rhos": []})
        f["cells"] += 1
        cands = cell["candidates"]
        analytic = [c["analytic_time_s"] for c in cands]
        measured = [c["measured_time_s"] for c in cands]
        best_analytic = min(analytic)
        win_i = min(range(len(cands)),
                    key=lambda i: (measured[i], analytic[i], i))
        if analytic[win_i] <= (1.0 + top1_tol) * best_analytic:
            f["top1_ok"] += 1
        else:
            violations.append(
                f"{key}: measured winner blocks="
                f"{cands[win_i]['blocks']} has analytic time "
                f"{analytic[win_i]:.3e}s vs best {best_analytic:.3e}s "
                f"(> {1 + top1_tol:.2f}x)")
        if len(cands) >= 3:
            f["rhos"].append(spearman(measured, analytic))
    families = {}
    for op, f in sorted(fams.items()):
        agree = f["top1_ok"] / f["cells"]
        rho = (sum(f["rhos"]) / len(f["rhos"])) if f["rhos"] else 1.0
        families[op] = {"cells": f["cells"], "top1_agreement": agree,
                        "mean_spearman": rho}
        if rho < min_spearman:
            violations.append(
                f"family {op}: mean Spearman {rho:.3f} < {min_spearman}")
    return {"ok": not violations, "n_cells": sum(f["cells"]
                                                 for f in fams.values()),
            "top1_tol": top1_tol, "min_spearman": min_spearman,
            "families": families, "violations": violations}
