"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--out DIR] [--baseline-csrc DIR]

Phases, each of which raises on failure (exit code non-zero):

1. Device: refuse to run without CUDA; print the card's name and power
   limit as nvidia-smi gives them.
2. Build: compile the ten CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, in parallel); print the build time and what
   ptxas reports for each kernel.
3. Kernels: each kernel against its plain torch version on the card, at the
   llama-1b main-path shapes (prefill B 4, S 256, so M = 1024; decode B 4
   over a 296-slot cache; paged decode over 8 slots of an 8-page bucket of
   a 65-page pool, a 128-token chunk at position 192 and a 4-token verify;
   the forward GEMM's prefill, decode and training (M = 4096) launches,
   the gated one saving its preacts as autograd does, each also at every
   tile width and split count against the planner's pick;
   the training backward at B 4, S 1024, so M = 4096: the GEMM backward
   of the four fused GEMMs of a layer as its operand pass, dA (the GEMM
   and the norm row pass also timed apart) and dB, each tile width of the
   mainloop timed too, and the whole backward against the library's two
   products; the flash backward whole, its main kernel and its dq
   conversion timed apart; the standalone
   RoPE on prefill and training q/k, strided views of the q|k GEMM output,
   and its backward; the fused dropout + residual + layernorm at the
   memory-bound bench's shapes, rows 2048-8192 by d 2048, p 0.1, seed 7),
   with the stated tolerance; kernel, plain and library times with CUDA
   events (L2 scrubbed before every launch), and the least time the card
   could take (bytes over 3.35 TB/s or operations over their peak,
   whichever is larger: products of two bf16 operands at 989 TFLOP/s, those
   with an fp32 operand, such as the softmax weights of p @ v, at 67
   TFLOP/s). The paged kernel at page 64 and
   one query token must equal ``flash_decode`` over the gathered pages bit
   for bit. No PyTorch call computes paged attention: its yardstick is
   ``F.scaled_dot_product_attention`` over the pre-gathered cache, the
   gather not timed. The GEMM backward's yardstick is ``torch.matmul`` of
   the bare product (the operand pass has none). The flash backward's
   yardstick is ``torch.autograd.grad`` through
   ``F.scaled_dot_product_attention``, replayed from a CUDA graph like
   every other yardstick, its grads first held to the plain version (1% in
   norm; the entries outside the kernel's tolerance counted). With
   ``--baseline-csrc DIR`` (an earlier tree's csrc: dA and dB sources
   with this tree's entry points; a WMMA forward ``gemm_fused.cu`` whose
   entry point takes no plan and a two-pass ``flash_bwd.cu``, each where
   the tree has it), the earlier forward is timed in turns with this one
   at every forward shape, the earlier dA + dB with this one's and the
   earlier flash backward with this one (baseline, new, new, baseline).
   No PyTorch call computes RoPE (no library
   time); the fused norm's yardstick is ``F.layer_norm`` of the summed
   residual, without the dropout, the add and the residual output.
4. The slice: llama-1b at full width with seeded random weights, 8 requests
   (prompts of 128-256 tokens, 32 new tokens, greedy) through
   ``RequestQueue(Engine(...), batch_size=4, buckets=(256,))`` in kernel
   mode; every kernel launch counter is zeroed just before and read just
   after, and must equal the launches the path makes. Then teacher forcing:
   the served token streams go through the kernel path, the plain bf16 path
   and the plain fp32 path; the kernel path's per-step logits must be no
   further from fp32 than 2x the plain bf16 path's distance + 1e-2.
5. The paged slice: ``PagedEngine`` in kernel mode. (a) Under pool
   pressure: 8 slots, page 64, 8 pages a sequence, a 33-page pool, 16
   requests (prompts of 96-320 tokens, 16-64 new tokens, greedy); at least
   one preemption. (b) The fast paths: ``prefix_cache=True`` and
   ``chunk_tokens=128``, 12 requests sharing a 192-token prefix plus 32-160
   tokens of their own; at least one prefix hit and one chunk. Each checks
   completion, prompts and lengths, the pool accounting, and that every
   kernel launch counter (zeroed just before, read just after) equals what
   the engine's own counters imply. Then teacher forcing: two served
   streams per phase that were neither preempted nor prefix-matched are
   replayed through the same route in a lone slot; the replay's greedy
   tokens must equal the served ones exactly, and its logits must be no
   further from the fp32 plain path than 2x the plain bf16 path's distance
   + 1e-2.
6. Training. (a) Gradients at full width: llama-1b at 2 layers, one batch
   of 4 x 1024 tokens from the ported pipeline; the per-leaf grads of
   ``lm_loss`` in kernel mode (bf16), in reference mode (bf16) and in
   reference mode at fp32 (the truth): every leaf's kernel-mode error
   against the truth no larger than 2x the bf16 reference mode's + 1e-3.
   (b) All 16 layers of llama-1b trained through ``train_loop`` for 8
   steps of 4 x 1024 tokens (``cosine_schedule``, 2 warm-up steps,
   ``remat_policy="full"``) in kernel mode: every launch counter, zeroed
   just before and read just after, equals 8 steps of what the model
   implies (per layer and step 8 ``gemm_fused``, 4 GEMM-backward operand
   passes, 4 dA, 4 dB, 2 flash forward and 2 flash backward launches,
   the main kernel and the dq conversion); every loss finite and the last
   below the first; then the same 8 steps on the plain bf16 path and the
   plain fp32 path (the truth, same seed and data): the kernel curve no
   further from the truth than 2.5x the plain bf16 curve's distance +
   0.05. Prints tokens/s and step time (median of the steps after the
   first), the peak device memory and the device-busy share of one traced
   step.
7. The ladder's standalone-RoPE rungs and the fused norm op. (a) Phase 4's
   traffic served by a model built with ``qkv_plan="norm_fused"`` (the
   norm-prologue q|k and v GEMMs without the rope store, then the RoPE
   kernel): launches exact (32 ``rope`` per served batch), teacher-forced
   logits under phase 4's bound. (b) 3 steps of phase 6b's training on
   ``qkv_plan="norm_fused"`` (96 ``rope`` a step: forward, recompute,
   backward), the curve no further from 6b's fp32 curve over those steps
   than 2.5x the plain bf16 curve's distance + 0.05. (c) One teacher-forced
   pass of 7a's tokens with ``qkv_plan="unfused"`` (standalone norm, plain
   projections, the RoPE kernel) under the same bound. (d)
   ``dropout_residual_layernorm`` through the public op at the bench's
   shapes (fp32, and bf16 at 8192 rows): outputs against the plain
   version, and the kernel's keep-mask, read from a probe call with x = 1
   and residual = 0, bit for bit the plain version's.
8. One JSON line of per-kernel numbers, the nvidia-smi line, and the last
   line ``{"ok": true, "device": {...}}``.

``--out DIR`` also writes the full report to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, DataIterator  # noqa: E402
from repro_torch.kernels.attention import (  # noqa: E402
    BLOCK_KV, combine_splits, decode_partials_paged_ref, decode_partials_ref,
    flash_attention_bwd_ref, flash_attention_fwd, flash_attention_fwd_ref,
    flash_decode, flash_decode_paged)
from repro_torch.kernels.attention import backward as attn_bwd  # noqa: E402
from repro_torch.kernels.gemm import (EPILOGUE_NONE, PROLOGUE_NONE,  # noqa: E402
                                      Epilogue, Prologue, rms_rows_ref)
from repro_torch.kernels.gemm import backward as gemm_bwd  # noqa: E402
from repro_torch.kernels.gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.gemm.ops import _forward as gemm_forward  # noqa: E402
from repro_torch.kernels.fused_norm import (  # noqa: E402
    dropout_keep_mask_ref, dropout_residual_layernorm,
    fused_dropout_residual_layernorm_ref)
from repro_torch.kernels.rope import (rope_launch, rope_ref,  # noqa: E402
                                      rope_tables)
from repro_torch.launch.profile_train import profile_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import nest, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.optim.optimizer import named_leaves  # noqa: E402
from repro_torch.serve import (Engine, PagedEngine, Request,  # noqa: E402
                               RequestQueue)
from repro_torch.serve import kv_cache as kvc  # noqa: E402
from repro_torch.train import loss_and_grads, train_loop  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12      # outside the tensor cores
HBM_BYTES_S = 3.35e12

BATCH, PROMPT, NEW_TOKENS, REQUESTS = 4, 256, 32, 8
MAX_LEN = PROMPT + NEW_TOKENS + 8          # as the serving launcher sizes it
# the paged slice: PagedEngine geometry and the chunk of phase 5b
SLOTS, PAGE, MAX_PAGES, CHUNK = 8, 64, 8, 128
# the training slice: batch x sequence a step, steps, peak learning rate
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1024, 8, 1e-3
# phase 7b: steps of 6b's run on the ladder's rung 2
LADDER_STEPS = 3
# the memory-bound bench's fused-norm cells (benchmarks/bench_memory_bound.py)
NORM_ROWS, NORM_D, NORM_P, NORM_SEED = (2048, 4096, 8192), 2048, 0.1, 7

SOURCES = {
    "gemm_fused": ("src/repro_torch/kernels/csrc/gemm_fused.cu",
                   "src/repro/kernels/gemm/kernel.py:84"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                            "src/repro/kernels/attention/kernel_fwd.py:45"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/attention/kernel_decode.py:109"),
    "flash_decode_paged": ("src/repro_torch/kernels/csrc/flash_decode_paged.cu",
                           "src/repro/kernels/attention/kernel_decode.py:132"),
    # the transposed epilogue of _da_kernel (:73) and _db_kernel, A's norm
    "gemm_bwd_g": ("src/repro_torch/kernels/csrc/gemm_bwd_g.cu",
                   "src/repro/kernels/gemm/backward.py:73"),
    "gemm_bwd_da": ("src/repro_torch/kernels/csrc/gemm_bwd_da.cu",
                    "src/repro/kernels/gemm/backward.py:63"),
    "gemm_bwd_db": ("src/repro_torch/kernels/csrc/gemm_bwd_db.cu",
                    "src/repro/kernels/gemm/backward.py:226"),
    # one kernel for _dq_kernel (:71) and _dkv_kernel (:114)
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                            "src/repro/kernels/attention/kernel_bwd.py:71"),
    "rope": ("src/repro_torch/kernels/csrc/rope.cu",
             "src/repro/kernels/rope/kernel.py:28"),
    "fused_norm": ("src/repro_torch/kernels/csrc/fused_norm.cu",
                   "src/repro/kernels/fused_norm/kernel.py:43"),
}
# the phases whose launches are the main path's (6a only checks grads)
MAIN_PATH_PHASES = ("4", "5a", "5b", "6b", "7a", "7b", "7c", "7d")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median device milliseconds of one call. The call is captured once in
    a CUDA graph and replayed between two CUDA events, so the time is the
    device's and not the Python wrapper's enqueue time. A 128 MiB buffer is
    rewritten before every replay: the 50 MB L2 starts cold, as it does for
    weights streamed once per layer, and the device is still busy with it
    while the host enqueues the replay."""

    def __init__(self, device, iters: int = 10, warmup: int = 2):
        self.scrub = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        self.iters, self.warmup = iters, warmup

    def ms(self, fn, stream=None) -> float:
        """``stream``: warm up and capture on it (the stream that autograd
        runs a recorded graph's backward on), else on a side stream."""
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
            self.scrub.zero_()
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize()
        del graph
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_: float, *work) -> tuple:
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the
    memory rate and the operations over their peaks; ``work`` is pairs
    (flops, peak FLOP/s)."""
    t_ops = sum(flops / peak for flops, peak in work) * 1e3
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name, got, want, rtol, atol_frac):
    """Elementwise |got - want| <= rtol |want| + atol_frac * rms(want)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    atol = atol_frac * want.pow(2).mean().sqrt().item()
    err = (got - want).abs()
    bad = err > rtol * want.abs() + atol
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"rtol {rtol} + atol {atol:.3g}; max abs err {err.max().item():.4g}")
    return err.max().item(), f"rtol {rtol:g} + {atol_frac:g} x rms"


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version at the main-path shapes
# ---------------------------------------------------------------------------

def gemm_cases(cfg, dev, gen):
    """One layer's gemm_fused launches: prefill q|k (+rope), v, SwiGLU up and
    down (residual, scale); decode up and down; q|k without rope (rung 2 of
    the QKV ladder); and the training forward's four at M = 4 x 1024, the
    SwiGLU up projection saving its preacts as the autograd forward does.
    (name, a, b, kwargs, save_preact)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nqk = (cfg.num_heads + cfg.num_kv_heads) * hd
    nv = cfg.num_kv_heads * hd
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    gamma = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
    rms = dict(prologue=Prologue(norm="rmsnorm"), gamma=gamma)
    m = BATCH * PROMPT
    pos = torch.arange(PROMPT, device=dev)
    sin, cos = rope_tables(pos, hd, cfg.rope_theta)
    sin, cos = sin.repeat(BATCH, 1), cos.repeat(BATCH, 1)
    wd = d ** -0.5
    wf = f ** -0.5
    x_pre, x_dec = rnd(m, d), rnd(BATCH, d)
    w_gate, w_in, w_out = rnd(d, f, std=wd), rnd(d, f, std=wd), rnd(f, d, std=wf)
    gate_ep = Epilogue(activation="silu", gate=True)
    res_ep = Epilogue(residual=True, scale=True)
    cases = [
        ("prefill_qk_rope", x_pre, rnd(d, nqk, std=wd),
         dict(epilogue=Epilogue(rope=True, head_dim=hd), sin=sin, cos=cos,
              **rms)),
        ("prefill_v", x_pre, rnd(d, nv, std=wd), dict(**rms)),
        ("prefill_up", x_pre, w_gate, dict(epilogue=gate_ep, b2=w_in, **rms)),
        ("prefill_down", rnd(m, f), w_out,
         dict(epilogue=res_ep, residual=rnd(m, d), scale=1.0)),
        ("decode_up", x_dec, w_gate, dict(epilogue=gate_ep, b2=w_in, **rms)),
        ("decode_down", rnd(BATCH, f), w_out,
         dict(epilogue=res_ep, residual=rnd(BATCH, d), scale=1.0)),
    ]
    # the ladder's rung 2 (phase 7): the same q|k GEMM without the rope store
    cases.append(("prefill_qk", x_pre, cases[0][2], dict(**rms)))
    cases = [(*c, False) for c in cases]
    for name, a, b, kw in train_gemm_cases(cfg, dev, gen)[:4]:
        cases.append((f"train_{name}", a, b, kw, "b2" in kw))
    return cases


def fwd_args(kw):
    """(epilogue, prologue, the other keyword arguments of ops._launch and
    ops.forward_ref) of a case's gemm_fused keyword arguments."""
    return (kw.get("epilogue", EPILOGUE_NONE),
            kw.get("prologue", PROLOGUE_NONE),
            dict(b2=kw.get("b2"), bias=None, residual=kw.get("residual"),
                 scale=kw.get("scale"), sin=kw.get("sin"), cos=kw.get("cos"),
                 gamma=kw.get("gamma"), out_dtype=torch.bfloat16))


def entry_arity(path: str, entry: str) -> int:
    """The number of parameters of a C entry point in a source."""
    import re
    with open(path) as fh:
        match = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)", fh.read())
    return len(match.group(1).split(",")) if match else 0


def baseline_kernels(csrc: str) -> dict:
    """An earlier tree's kernels, built like the port's from the sources in
    ``csrc`` (their own headers included): GEMM backward dA and dB (whose
    entry points are this tree's), and, where the tree has them, the WMMA
    forward ``gemm_fused.cu`` (its own entry point: no row-pass scratch,
    workspace or plan; None when the entry is this tree's, PR 16's on) and
    the two-pass WMMA ``flash_bwd.cu`` (its own entry point: pass 0 dq,
    pass 1 dk and dv; None when the entry is this tree's)."""
    from repro_torch.kernels._build import CudaKernel, build_all

    P, I, Fl, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    root = os.path.abspath(csrc)
    wmma_fwd = [P] * 12 + [Fl, Fl] + [I] * 5 + [P]
    two_pass = [P] * 9 + [I] * 7 + [L] * 12 + [Fl, Fl, I, I, P]
    kerns = {
        "da": CudaKernel("baseline_gemm_bwd_da",
                         os.path.join(root, "gemm_bwd_da.cu"),
                         "gemm_bwd_da_launch", gemm_bwd.DA_KERNEL.argtypes),
        "db": CudaKernel("baseline_gemm_bwd_db",
                         os.path.join(root, "gemm_bwd_db.cu"),
                         "gemm_bwd_db_launch", gemm_bwd.DB_KERNEL.argtypes)}
    for key, src, entry, args in (
            ("fwd", "gemm_fused.cu", "gemm_fused_launch", wmma_fwd),
            ("flash_bwd", "flash_bwd.cu", "flash_bwd_launch", two_pass)):
        path = os.path.join(root, src)
        if entry_arity(path, entry) == len(args):
            kerns[key] = CudaKernel(f"baseline_{src[:-3]}", path, entry, args)
    log(f"[build] baseline from {root}: {sorted(kerns)}")
    build_all(list(kerns.values()))
    return {"fwd": None, "flash_bwd": None, **kerns}


def baseline_fwd(kern, a, b, kw, save):
    """A launch of the earlier forward on one case's operands; its launches
    are not counted."""
    ep, pro, extra = fwd_args(kw)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    rstd = (torch.empty((m,), dtype=torch.float32, device=a.device)
            if extra["gamma"] is not None else None)
    pre = ([torch.empty_like(out) for _ in range(2)] if save
           else [None, None])

    def ptr(t):
        return None if t is None else t.data_ptr()

    scale = float(extra["scale"]) if extra["scale"] is not None else 1.0

    def launch():
        kern.check(kern.fn()(
            ptr(a), ptr(b), ptr(extra["b2"]), ptr(out), ptr(extra["gamma"]),
            ptr(rstd), None, ptr(extra["residual"]), ptr(extra["sin"]),
            ptr(extra["cos"]), ptr(pre[0]), ptr(pre[1]), scale,
            float(pro.eps or 0.0), m, n, k, gemm_ops.chain_flags(ep),
            ep.head_dim, torch.cuda.current_stream().cuda_stream))
        return out
    return launch


def measure_gemm(cfg, dev, gen, timer, old=None):
    """Each gemm_fused launch of the main paths against its plain version
    (the output, the gated chain's saved preacts and the row statistics),
    timed as planned and at every (tile width, split count) the sweep
    reaches: each width the chain takes, unsplit and split as the planner
    would split it at that width; with the rmsnorm prologue also without
    it (the row pass's share). Library yardstick: the bare product(s)
    in one torch.matmul call (no single PyTorch call computes the fused
    chain). Bound: the operands read and the outputs (with rstd and the
    preacts) written once, or 2 M N K operations per product at the bf16
    peak. With ``old`` (baseline_kernels), the earlier forward in turns."""
    rows = []
    sms = gemm_ops.sm_count(dev)
    for name, a, b, kw, save in gemm_cases(cfg, dev, gen):
        ep, pro, extra = fwd_args(kw)
        m, k = a.shape
        n = b.shape[1]
        gated = ep.gate
        hd = ep.head_dim if ep.rope else 0

        def kernel(plan=None):
            return gemm_ops._launch(a, b, ep, eps=pro.eps, save_preact=save,
                                    plan=plan, **extra)

        def plain():
            return gemm_ops.forward_ref(a, b, ep, pro, save_preact=save,
                                        **extra)

        got, rstd, preacts = kernel()
        want, _, want_pre = plain()
        torch.cuda.synchronize()
        err, tol = check_close(f"gemm_fused[{name}]", got, want, 2 ** -6,
                               2e-2)
        for i, (p_, w_) in enumerate(zip(preacts, want_pre)):
            err = max(err, check_close(f"gemm_fused[{name}].preact{i + 1}",
                                       p_, w_, 2 ** -6, 2e-2)[0])
        if rstd is not None:
            check_close(f"gemm_fused[{name}].rstd", rstd,
                        rms_rows_ref(a, kw["gamma"], pro.eps)[1], 1e-5, 0.0)
        del want, want_pre
        b_lib = torch.cat([b, kw["b2"]], dim=1) if gated else b
        flops = 2 * m * n * k * (2 if gated else 1)
        traffic = nbytes(a, b, kw.get("b2"), kw.get("gamma"),
                         kw.get("residual"), kw.get("sin"), kw.get("cos"),
                         got, rstd, *preacts)
        b_ms, b_by = bound(traffic, (flops, PEAK_BF16))
        plan = gemm_ops.plan_gemm(m, n, k, sms, gate=gated, head_dim=hd)
        sweep = {}
        for w in gemm_ops.tile_widths(gated, hd):
            split = gemm_ops.split_count(
                gemm_ops.tile_count(m, n, w, gated), k, sms)
            for sp in sorted({1, split}):
                sweep[f"{w}x{sp}"] = timer.ms(lambda: kernel((w, sp)))
        row = dict(
            case=name, shape=[m, k, n], max_abs_err=err, tolerance=tol,
            saves_preacts=save, ms=timer.ms(kernel), plain_ms=timer.ms(plain),
            library_ms=timer.ms(lambda: torch.matmul(a, b_lib)),
            bound_ms=b_ms, bound_by=b_by, plan=f"{plan[0]}x{plan[1]}",
            ms_by_plan=sweep)
        if extra["gamma"] is not None:
            # the row pass's share: the same product without the prologue
            no_norm = dict(extra, gamma=None)
            row["no_prologue_ms"] = timer.ms(lambda: gemm_ops._launch(
                a, b, ep, eps=None, save_preact=save, **no_norm))
        us = {p_: round(t * 1e3, 1) for p_, t in sweep.items()}
        log(f"[kernel] gemm_fused[{name}] by tile width x splits, us: {us}; "
            f"picked {row['plan']}, fastest {min(sweep, key=sweep.get)}"
            + (f"; without the prologue {row['no_prologue_ms'] * 1e3:.1f} "
               f"us against {row['ms'] * 1e3:.1f}"
               if "no_prologue_ms" in row else ""))
        if old is not None and old["fwd"] is not None:
            old_fn = baseline_fwd(old["fwd"], a, b, kw, save)
            # the baseline computes the same function
            check_close(f"baseline gemm_fused[{name}]", old_fn(), got,
                        2 ** -6, 2e-2)
            turns = [timer.ms(old_fn), timer.ms(kernel), timer.ms(kernel),
                     timer.ms(old_fn)]
            row.update(baseline_turns_ms=turns,   # baseline, new, new, baseline
                       baseline_ms=(turns[0] + turns[3]) / 2,
                       new_in_turns_ms=(turns[1] + turns[2]) / 2)
            log(f"[kernel] gemm_fused[{name}] baseline "
                f"{row['baseline_ms'] * 1e3:.1f} us against "
                f"{row['new_in_turns_ms'] * 1e3:.1f} in turns")
        rows.append(row)
        del got, rstd, preacts, b_lib
    return rows


def measure_flash(cfg, dev, gen, timer):
    """Prefill attention with q/k/v as the model passes them: strided views
    of the q|k projection output and the v projection output."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16
    qk = torch.randn(BATCH, PROMPT, (h + hkv) * hd, generator=gen,
                     device=dev).to(bf16)
    v = torch.randn(BATCH, PROMPT, hkv * hd, generator=gen, device=dev).to(bf16)
    q = qk[..., : h * hd].reshape(BATCH, PROMPT, h, hd).transpose(1, 2)
    k = qk[..., h * hd:].reshape(BATCH, PROMPT, hkv, hd).transpose(1, 2)
    v = v.reshape(BATCH, PROMPT, hkv, hd).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    want, want_lse = flash_attention_fwd_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, tol = check_close("flash_attention_fwd", out, want, 2e-2, 2e-2)
    lse_err, _ = check_close("flash_attention_fwd[lse]", lse, want_lse, 1e-4,
                             1e-4)
    pairs = BATCH * h * PROMPT * (PROMPT + 1) // 2     # causal (q, k) pairs
    traffic = nbytes(q, k, v, out, lse)
    b_ms, b_by = bound(traffic, (4 * pairs * hd, PEAK_BF16))
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    return [dict(
        case="prefill_causal_gqa", shape=[BATCH, h, hkv, PROMPT, hd],
        max_abs_err=max(err, lse_err), tolerance=tol,
        ms=timer.ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
        plain_ms=timer.ms(lambda: flash_attention_fwd_ref(q, k, v,
                                                          causal=True)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by)]


def measure_decode(cfg, dev, gen, timer):
    """The last decode step of the main path: every sequence at position
    PROMPT + NEW_TOKENS - 2 of a MAX_LEN-slot cache."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    bf16 = torch.bfloat16
    length = PROMPT + NEW_TOKENS - 1
    q = torch.randn(BATCH, hkv, g, hd, generator=gen, device=dev).to(bf16)
    kc = torch.randn(BATCH, hkv, MAX_LEN, hd, generator=gen, device=dev).to(bf16)
    vc = torch.randn(BATCH, hkv, MAX_LEN, hd, generator=gen, device=dev).to(bf16)
    lengths = torch.full((BATCH,), length, dtype=torch.int32, device=dev)
    scale = hd ** -0.5

    def plain():
        o, m, l = decode_partials_ref(q, kc, vc, lengths, scale=scale)
        return combine_splits(o, m, l).to(q.dtype)

    got = flash_decode(q, kc, vc, lengths)
    want = plain()
    torch.cuda.synchronize()
    err, tol = check_close("flash_decode", got, want, 2e-2, 2e-2)
    # what this step needs: q, the valid cache rows, lengths; the output
    traffic = (nbytes(q, lengths, got)
               + 2 * BATCH * hkv * length * hd * kc.element_size())
    # q @ k^T has two bf16 operands; p @ v has the fp32 softmax weights
    flops = 2 * BATCH * h * length * hd
    b_ms, b_by = bound(traffic, (flops, PEAK_BF16), (flops, PEAK_FP32))
    mask = (torch.arange(MAX_LEN, device=dev) < length).expand(BATCH, 1, 1,
                                                               MAX_LEN)
    q4 = q.reshape(BATCH, h, 1, hd)
    return [dict(
        case="decode_step", shape=[BATCH, h, hkv, MAX_LEN, hd],
        split=BLOCK_KV, max_abs_err=err, tolerance=tol,
        ms=timer.ms(lambda: flash_decode(q, kc, vc, lengths)),
        plain_ms=timer.ms(plain),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by)]


def paged_cases(cfg, dev, gen):
    """The paged kernel's three shapes on the main path, over one 65-page
    pool whose tables are a seeded permutation: (name, q, table, lengths,
    q_tokens)."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    bf16 = torch.bfloat16
    perm = np.random.default_rng(1).permutation(
        np.arange(1, SLOTS * MAX_PAGES + 1)).reshape(SLOTS, MAX_PAGES)
    table = torch.from_numpy(perm.astype(np.int32)).to(dev)

    def q(b, rows):
        return torch.randn(b, hkv, rows, hd, generator=gen, device=dev).to(bf16)

    def lens(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    return [
        # ragged decode lengths: an empty row and page-boundary crossings
        ("decode", q(SLOTS, g), table,
         lens(0, 1, 64, 65, 130, 257, 400, 512), 1),
        ("chunk", q(1, g * CHUNK), table[:1], lens(192 + CHUNK), CHUNK),
        ("verify", q(SLOTS, g * 4), table,
         lens(4, 64, 68, 130, 257, 300, 400, 512), 4),
    ]


def measure_paged(cfg, dev, gen, timer):
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    bf16 = torch.bfloat16
    n_pages = SLOTS * MAX_PAGES + 1
    k_pages = torch.randn(n_pages, hkv, PAGE, hd, generator=gen,
                          device=dev).to(bf16)
    v_pages = torch.randn(n_pages, hkv, PAGE, hd, generator=gen,
                          device=dev).to(bf16)
    scale = hd ** -0.5
    rows = []
    for name, q, table, lengths, t in paged_cases(cfg, dev, gen):
        def plain():
            o, m, l = decode_partials_paged_ref(q, k_pages, v_pages, table,
                                                lengths, scale=scale,
                                                q_tokens=t)
            return combine_splits(o, m, l).to(q.dtype)

        def kernel():
            return flash_decode_paged(q, k_pages, v_pages, table, lengths,
                                      q_tokens=t)

        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err, tol = check_close(f"flash_decode_paged[{name}]", got, want,
                               2e-2, 2e-2)
        if name == "decode":
            # shared split body: page 64 == BLOCK_KV and T = 1 give the
            # contiguous kernel's bits over the gathered pages
            dense = flash_decode(q, kvc.gather_pages(k_pages, table),
                                 kvc.gather_pages(v_pages, table), lengths)
            torch.cuda.synchronize()
            if not torch.equal(got, dense):
                raise AssertionError("flash_decode_paged differs from "
                                     "flash_decode over the gathered pages")
        # what this call needs: the valid K/V rows once, q, the table, the
        # lengths and the output; every (row, visible key) pair's products,
        # q @ k^T on two bf16 operands and p @ v on the fp32 weights
        b = q.shape[0]
        hz = (lengths.long()[:, None] - t + 1
              + torch.arange(t, device=dev)[None, :])           # keys seen
        pairs = int(hz.clamp(min=0).sum()) * g * hkv
        valid_rows = int(lengths.long().sum())
        traffic = (nbytes(q, table, lengths, got)
                   + 2 * valid_rows * hkv * hd * k_pages.element_size())
        flops = 2 * pairs * hd
        b_ms, b_by = bound(traffic, (flops, PEAK_BF16), (flops, PEAK_FP32))
        # yardstick: SDPA over the pre-gathered contiguous cache
        kg = kvc.gather_pages(k_pages, table)
        vg = kvc.gather_pages(v_pages, table)
        span = kg.shape[2]
        q4 = q.reshape(b, hkv, g, t, hd).reshape(b, h, t, hd)
        idx = torch.arange(span, device=dev)
        mask = (idx[None, None, :] < hz[:, :, None])[:, None]  # (B, 1, T, S)
        rows.append(dict(
            case=name, shape=[b, h, hkv, t, MAX_PAGES * PAGE, hd],
            page=PAGE, max_abs_err=err, tolerance=tol,
            ms=timer.ms(kernel), plain_ms=timer.ms(plain),
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by))
        if name == "decode":
            rows[-1]["bitwise_vs_flash_decode"] = True
    return rows


def train_gemm_cases(cfg, dev, gen):
    """One layer's four fused GEMMs at the training shape (M = 4 x 1024
    tokens): q|k (+rope) and v behind the rmsnorm prologue, the SwiGLU up
    projection, the down projection with its scaled residual; and rung 2's
    q|k GEMM without the rope store."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nqk = (cfg.num_heads + cfg.num_kv_heads) * hd
    m = TRAIN_BATCH * TRAIN_SEQ
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)

    gamma = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
    rms = dict(prologue=Prologue(norm="rmsnorm"), gamma=gamma)
    sin, cos = rope_tables(torch.arange(TRAIN_SEQ, device=dev), hd,
                           cfg.rope_theta)
    x = rnd(m, d)
    wd, wf = d ** -0.5, f ** -0.5
    cases = [
        ("qk_rope", x, rnd(d, nqk, std=wd),
         dict(epilogue=Epilogue(rope=True, head_dim=hd),
              sin=sin.repeat(TRAIN_BATCH, 1), cos=cos.repeat(TRAIN_BATCH, 1),
              **rms)),
        ("v", x, rnd(d, cfg.num_kv_heads * hd, std=wd), dict(**rms)),
        ("swiglu_up", x, rnd(d, f, std=wd),
         dict(epilogue=Epilogue(activation="silu", gate=True),
              b2=rnd(d, f, std=wd), **rms)),
        ("down", rnd(m, f), rnd(f, d, std=wf),
         dict(epilogue=Epilogue(residual=True, scale=True),
              residual=rnd(m, d), scale=1.0)),
    ]
    # the ladder's rung 2 (phase 7b): the q|k GEMM without the rope store
    return cases + [("qk", x, cases[0][2], dict(**rms))]


def measure_gemm_bwd(cfg, dev, gen, timer, old=None):
    """The GEMM backward of each training GEMM, from the forward's saved
    rstd and preacts and a random cotangent, as its three launches: the
    operand pass (``gemm_bwd_g``), dA (the GEMM, and the norm row pass
    timed apart) and dB, each against its plain version. Bounds: the
    operand pass by its bytes (g, preacts, tables, A, gamma, rstd read;
    gbar, gbar_t, a_t written once); dA and dB by their own operands and
    outputs, or 2 M N K operations per product at the bf16 peak. Library
    yardstick: torch.matmul of the bare product (g @ Bᵀ, Aᵀ @ g; the gated
    chain's two products as one concatenated one). Also the whole backward
    (operand pass + dA + dB through ``gemm_fused_bwd``) against the
    library's two products, bound by the chain's inputs and outputs or both
    products. With ``old`` (baseline_kernels), the earlier tree's dA + dB
    on the same operand-pass buffers, which must give this tree's bits, in
    turns with this tree's dA + dB (baseline, new, new, baseline)."""
    rows = {"gemm_bwd_g": [], "gemm_bwd_da": [], "gemm_bwd_db": []}
    whole = []
    for name, a, b, kw in train_gemm_cases(cfg, dev, gen):
        ep = kw.get("epilogue", EPILOGUE_NONE)
        pro = kw.get("prologue", PROLOGUE_NONE)
        _, rstd, preacts = gemm_forward(
            a, b, ep, pro, b2=kw.get("b2"), bias=None,
            residual=kw.get("residual"), scale=kw.get("scale"),
            sin=kw.get("sin"), cos=kw.get("cos"), gamma=kw.get("gamma"),
            out_dtype=torch.bfloat16, save_preact=ep.gate)
        m, k = a.shape
        n = b.shape[1]
        g = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        ops = dict(epilogue=ep, prologue=pro, b2=kw.get("b2"), bias=None,
                   scale=kw.get("scale"), sin=kw.get("sin"), cos=kw.get("cos"),
                   gamma=kw.get("gamma"), preacts=preacts)
        g_ops = {x: v for x, v in ops.items() if x != "b2"}
        run = gemm_bwd.BwdLaunch(a, b, g, rstd=rstd, **ops)
        norm = run.norm

        run.operand_pass()
        da, dgamma = run.da()
        db, db2 = run.db()
        want_g = gemm_bwd.gemm_bwd_g_ref(a, g, rstd=rstd, **g_ops)
        want_da, want_dgamma = gemm_bwd.gemm_bwd_da_ref(a, b, g, **ops)
        want_db, want_db2, _ = gemm_bwd.gemm_bwd_db_ref(a, b, g, rstd=rstd,
                                                        **ops)
        torch.cuda.synchronize()
        # the operand pass: one bf16 rounding of the same fp32 value
        err_g, tol_g = check_close(f"gemm_bwd_g[{name}]", run.gbar,
                                   want_g["gbar"], 2 ** -7, 1e-6)
        if not (torch.equal(run.gbar_t[:, :m], run.gbar.T)
                and torch.equal(run.a_t[:, :m].float(), want_g["a_t"])):
            raise AssertionError(f"gemm_bwd_g[{name}]: gbar_t is not gbar's "
                                 "transpose, or a_t not the plain An^T")
        tol = 2 ** -6, 2e-2
        err_a, tol_s = check_close(f"gemm_bwd_da[{name}]", da, want_da, *tol)
        if dgamma is not None:
            err_gm, _ = check_close(f"gemm_bwd_da[{name}].dgamma", dgamma,
                                    want_dgamma, 1e-3, 1e-3)
            err_a = max(err_a, err_gm)
        err_b, _ = check_close(f"gemm_bwd_db[{name}]", db, want_db, *tol)
        if db2 is not None:
            err_b = max(err_b, check_close(f"gemm_bwd_db[{name}].db2", db2,
                                           want_db2, *tol)[0])
        del want_g, want_da, want_db, want_db2
        gated = ep.gate
        flops = 2 * m * n * k * (2 if gated else 1)
        g_in = nbytes(g, *preacts, kw.get("sin"), kw.get("cos"))
        a_in = nbytes(a, kw.get("gamma"), rstd)
        n2 = run.gbar.shape[1]
        g_out = 2 * m * n2 * 2 + k * m * 2          # gbar, gbar_t, a_t
        da_in = nbytes(run.gbar, b, kw.get("b2")) + (a_in if norm else 0)
        db_in = 2 * (k * m + n2 * m)                 # a_t, gbar_t
        out_da, out_db = nbytes(da, dgamma), nbytes(db, db2)
        g_lib = torch.cat([g, g], dim=1) if gated else g
        b_lib = torch.cat([b, kw["b2"]], dim=1) if gated else b

        def lib_da():
            return torch.matmul(g_lib, b_lib.T)

        def lib_db():
            return torch.matmul(a.T, g_lib)

        def lib_both():
            return lib_da(), lib_db()

        def new_whole():
            return gemm_bwd.gemm_fused_bwd(a, b, g, rstd=rstd, **ops)

        shape = [m, k, n]
        b_ms, b_by = bound(g_in + a_in + g_out)
        rows["gemm_bwd_g"].append(dict(
            case=name, shape=shape, max_abs_err=err_g, tolerance=tol_g,
            ms=timer.ms(run.operand_pass),
            plain_ms=timer.ms(lambda: gemm_bwd.gemm_bwd_g_ref(
                a, g, rstd=rstd, **g_ops)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        b_ms, b_by = bound(da_in + out_da, (flops, PEAK_BF16))
        da_row = dict(
            case=name, shape=shape, max_abs_err=err_a, tolerance=tol_s,
            ms=timer.ms(run.da),
            plain_ms=timer.ms(lambda: gemm_bwd.gemm_bwd_da_ref(a, b, g,
                                                               **ops)),
            library_ms=timer.ms(lib_da), bound_ms=b_ms, bound_by=b_by,
            gemm_ms=timer.ms(lambda: run.da(passes=1)))
        if norm:
            da_row["row_pass_ms"] = timer.ms(lambda: run.da(passes=2))
            da_row["row_pass_bound_ms"] = bound(
                nbytes(run.dan, a, da, kw.get("gamma"), rstd, dgamma))[0]
        rows["gemm_bwd_da"].append(da_row)
        b_ms, b_by = bound(db_in + out_db, (flops, PEAK_BF16))
        rows["gemm_bwd_db"].append(dict(
            case=name, shape=shape, max_abs_err=err_b, tolerance=tol_s,
            ms=timer.ms(run.db),
            plain_ms=timer.ms(lambda: gemm_bwd.gemm_bwd_db_ref(
                a, b, g, rstd=rstd, **ops)),
            library_ms=timer.ms(lib_db), bound_ms=b_ms, bound_by=b_by))
        # each tile width of the mainloop, against the one picked
        by_width = {}
        for width in gemm_bwd.TILE_WIDTHS:
            sweep = gemm_bwd.BwdLaunch(a, b, g, rstd=rstd, tile_n=width,
                                       **ops)
            sweep.operand_pass()
            by_width[width] = (timer.ms(lambda: sweep.da(passes=1)),
                               timer.ms(sweep.db))
            del sweep
        da_row.update(tile_n=run.tile_da, gemm_ms_by_tile_n={
            w: t[0] for w, t in by_width.items()})
        rows["gemm_bwd_db"][-1].update(tile_n=run.tile_db, ms_by_tile_n={
            w: t[1] for w, t in by_width.items()})
        us = {w: [round(x * 1e3, 1) for x in t] for w, t in by_width.items()}
        log(f"[kernel] gemm_bwd[{name}] by tile width, (dA GEMM, dB) us: "
            f"{us}; picked {run.tile_da} for dA, {run.tile_db} for dB")
        b_ms, b_by = bound(g_in + a_in + nbytes(b, kw.get("b2")) + out_da
                           + out_db, (2 * flops, PEAK_BF16))
        w = dict(case=name, shape=shape, ms=timer.ms(new_whole),
                 library_ms=timer.ms(lib_both), bound_ms=b_ms, bound_by=b_by)
        if old is not None:
            def new_both():
                run.da()
                run.db()

            def old_both():
                run.da(kernel=old["da"])
                run.db(kernel=old["db"])

            new_both()
            mine = [t.clone() for t in (run.da_out, run.db_out)]
            old_both()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in
                       zip(mine, (run.da_out, run.db_out))):
                raise AssertionError(f"gemm_bwd[{name}]: dA or dB differs "
                                     "from the baseline's bits")
            del mine
            turns = [timer.ms(old_both), timer.ms(new_both),
                     timer.ms(new_both), timer.ms(old_both)]
            w["baseline_turns_ms"] = turns     # baseline, new, new, baseline
            w["baseline_ms"] = (turns[0] + turns[3]) / 2
            w["new_in_turns_ms"] = (turns[1] + turns[2]) / 2
        whole.append(w)
        log(f"[kernel] gemm_fused_bwd[{name}] whole backward "
            f"{w['ms'] * 1e3:.1f} us (operand pass "
            f"{rows['gemm_bwd_g'][-1]['ms'] * 1e3:.1f}, dA GEMM "
            f"{da_row['gemm_ms'] * 1e3:.1f}, row pass "
            f"{da_row.get('row_pass_ms', 0.0) * 1e3:.1f}, dB "
            f"{rows['gemm_bwd_db'][-1]['ms'] * 1e3:.1f}); library products "
            f"{w['library_ms'] * 1e3:.1f} us; bound "
            f"{w['bound_ms'] * 1e3:.2f} us ({w['bound_by']})"
            + (f"; baseline dA + dB {w['baseline_ms'] * 1e3:.1f} us against "
               f"{w['new_in_turns_ms'] * 1e3:.1f} in turns"
               if old is not None else ""))
        del run, preacts, g, g_lib, b_lib, da, db, db2
    return rows, whole


def baseline_flash_bwd(kern, args):
    """The earlier two-pass flash backward (its own entry point: dq, dk, dv
    written by a dq pass and a dk/dv pass, no workspace) as one callable
    on the training case's causal inputs, delta computed as the wrapper
    computes it; its launches are not counted."""
    q, k, v, out, lse, do = args
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    lse32 = lse.float().contiguous()
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)

    def launch():
        delta = attn_bwd.attention_delta(out, do).contiguous()
        for which in (0, 1):
            kern.check(kern.fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse32.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), which, b, h, hkv, sq, skv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], float(d ** -0.5), 0.0, 1, 0,
                torch.cuda.current_stream().cuda_stream))
        return dq, dk, dv
    return launch


def measure_flash_bwd(cfg, dev, gen, timer, old=None):
    """The flash backward at the training shape (B 4, H 32, Hkv 8, S 1024,
    d 64, causal), q and k as views of the packed q|k output and dO as the
    strided cotangent autograd hands over, against the plain version. The
    whole backward (``flash_attention_bwd`` as the model calls it: delta,
    the zeroed dq workspace, the main kernel and the dq conversion) is
    bound by the five products per causal (q, k) pair (s, dp, dv, dk, dq)
    or by q, k, v, dO, lse and delta read and dq, dk, dv written once; the
    main kernel (timed apart on prepared buffers) by the same products or
    its bytes with the fp32 workspace written once; the conversion by the
    workspace read and dq written; the plain-torch delta and the
    workspace's zeroing are timed apart too. Yardstick: torch.autograd.grad through
    F.scaled_dot_product_attention, the forward not timed, captured in a
    CUDA graph on the stream that ran the forward (autograd runs each
    backward op on its forward's stream) and replayed like every other
    call; its dq, dk, dv are held to the plain version first. With ``old``
    (baseline_kernels), the earlier two-pass kernel, held to the plain
    version, in turns with this one (baseline, new, new, baseline)."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bsz, seq = TRAIN_BATCH, TRAIN_SEQ
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    qk = rnd(bsz, seq, (h + hkv) * hd)
    q = qk[..., : h * hd].reshape(bsz, seq, h, hd).transpose(1, 2)
    k = qk[..., h * hd:].reshape(bsz, seq, hkv, hd).transpose(1, 2)
    v = rnd(bsz, seq, hkv * hd).reshape(bsz, seq, hkv, hd).transpose(1, 2)
    do = rnd(bsz, seq, h, hd).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    args = (q, k, v, out, lse, do)
    opts = dict(causal=True, window=None, logit_scale=None, softcap=None)

    def kernel():
        return attn_bwd._launch(*args, **opts)

    qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    doc = do.contiguous()
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        ref_out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                 enable_gqa=True)

    def library():
        return torch.autograd.grad(ref_out, (qc, kc, vc), doc,
                                   retain_graph=True)

    with torch.cuda.stream(lib_stream):
        lib = library()
    torch.cuda.current_stream().wait_stream(lib_stream)
    got = kernel()
    want = flash_attention_bwd_ref(*args, causal=True)
    old_fn = (None if old is None or old["flash_bwd"] is None
              else baseline_flash_bwd(old["flash_bwd"], args))
    old_got = None if old_fn is None else old_fn()
    torch.cuda.synchronize()
    err = 0.0
    lib_err = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        w_ = want[i]
        e, tol = check_close(f"flash_attention_bwd[{name}]", got[i], w_,
                             2e-2, 2e-2)
        err = max(err, e)
        if old_got is not None:   # the baseline computes the same function
            check_close(f"baseline flash_attention_bwd[{name}]", old_got[i],
                        w_, 2e-2, 2e-2)
        # the yardstick computes the same function. It rounds at other
        # points than the plain version (which are the kernel's), and on an
        # H100 a few entries of millions miss the kernel's elementwise
        # tolerance (dq 1 of 8.4M, dk 1-15 of 2.1M, by up to 0.031), so it
        # is held to the plain version in norm, 1% of it, and the entries
        # outside the kernel's tolerance are counted
        lf, wf = lib[i].float(), w_.float()
        if not torch.isfinite(lf).all():
            raise AssertionError(f"sdpa backward[{name}]: non-finite")
        diff = lf - wf
        rel = (diff.norm() / wf.norm()).item()
        if rel > 1e-2:
            raise AssertionError(f"sdpa backward[{name}]: {rel:.3g} of the "
                                 "plain version's norm away")
        atol = 2e-2 * wf.pow(2).mean().sqrt().item()
        lib_err[name] = dict(
            relative_norm_err=rel, max_abs_err=diff.abs().max().item(),
            outside_kernel_tolerance=int(
                (diff.abs() > 2e-2 * wf.abs() + atol).sum()))
        del lf, wf, diff
    del got, want, lib, old_got
    work = attn_bwd.backward_work(bsz, h, hkv, seq, seq, hd, causal=True)
    products = (work["flops"], PEAK_BF16)
    b_ms, b_by = bound(work["bytes"], products)
    main_ms, main_by = bound(work["main_bytes"], products)
    conv_ms, _ = bound(work["convert_bytes"])
    run = attn_bwd.FlashBwdLaunch(*args, **opts)
    row = dict(
        case="train_causal_gqa", shape=[bsz, h, hkv, seq, hd],
        max_abs_err=err, tolerance=tol, ms=timer.ms(kernel),
        plain_ms=timer.ms(lambda: flash_attention_bwd_ref(*args,
                                                          causal=True)),
        library_ms=timer.ms(library, stream=lib_stream),
        library_vs_plain=lib_err, bound_ms=b_ms, bound_by=b_by,
        main=dict(replaces=["src/repro/kernels/attention/kernel_bwd.py:71",
                            "src/repro/kernels/attention/kernel_bwd.py:114"],
                  ms=timer.ms(run.main), bound_ms=main_ms,
                  bound_by=main_by),
        convert=dict(ms=timer.ms(run.convert), bound_ms=conv_ms,
                     bound_by="bytes"),
        # the whole's plain-torch parts: delta and the workspace's zeroing
        delta_ms=timer.ms(lambda: attn_bwd.attention_delta(out, do)),
        zero_ms=timer.ms(lambda: torch.zeros_like(run.dq_acc)))
    if old_fn is not None:
        turns = [timer.ms(old_fn), timer.ms(kernel), timer.ms(kernel),
                 timer.ms(old_fn)]
        row.update(baseline_turns_ms=turns,     # baseline, new, new, baseline
                   baseline_ms=(turns[0] + turns[3]) / 2,
                   new_in_turns_ms=(turns[1] + turns[2]) / 2)
    log(f"[kernel] flash_attention_bwd[train] whole {row['ms'] * 1e3:.1f} us "
        f"(bound {b_ms * 1e3:.2f}, {b_by}); main kernel "
        f"{row['main']['ms'] * 1e3:.1f} us (bound {main_ms * 1e3:.2f}, "
        f"{main_by}; {work['flops'] / row['main']['ms'] * 1e3 / PEAK_BF16:.1%}"
        f" of the bf16 peak); dq conversion {row['convert']['ms'] * 1e3:.1f} "
        f"us (bound {conv_ms * 1e3:.2f}, bytes); delta "
        f"{row['delta_ms'] * 1e3:.1f} us, zeroing {row['zero_ms'] * 1e3:.1f}"
        f" us; SDPA backward {row['library_ms'] * 1e3:.1f} us"
        + (f"; baseline {row['baseline_ms'] * 1e3:.1f} us against "
           f"{row['new_in_turns_ms'] * 1e3:.1f} in turns"
           if old_fn is not None else ""))
    del run
    return [row]


def measure_rope(cfg, dev, gen, timer):
    """The standalone RoPE at the ladder's rung-2 shapes: prefill (B 4, S
    256) and training (B 4, S 1024) q and k as the model hands them over,
    strided views of the bf16 q|k GEMM output; and the backward (the kernel
    with -sin) at the training q shape on a contiguous cotangent, as the
    flash backward hands it over. Plain version: rope_ref (the backward's
    with -sin). Bound: x read once, the output written once and both (S, D)
    tables read once; 6 operations a pair are far below the bytes."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16
    rows = []
    for stage, bsz, seq in (("prefill", BATCH, PROMPT),
                            ("train", TRAIN_BATCH, TRAIN_SEQ)):
        qk = torch.randn(bsz, seq, (h + hkv) * hd, generator=gen,
                         device=dev).to(bf16)
        q = qk[..., : h * hd].reshape(bsz, seq, h, hd).transpose(1, 2)
        k = qk[..., h * hd:].reshape(bsz, seq, hkv, hd).transpose(1, 2)
        sin, cos = rope_tables(torch.arange(seq, device=dev), hd,
                               cfg.rope_theta)
        cases = [(f"{stage}_q", q, 1.0), (f"{stage}_k", k, 1.0)]
        if stage == "train":
            cases.append(("train_q_bwd", torch.randn(
                q.shape, generator=gen, device=dev).to(bf16), -1.0))
        for name, x, sign in cases:
            def kernel(x=x, sign=sign):
                return rope_launch(x, sin, cos, sin_sign=sign)

            def plain(x=x, table=sin if sign > 0 else -sin):
                return rope_ref(x, table, cos)

            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            # one bf16 rounding of the same fp32 value: at most one ulp
            err, tol = check_close(f"rope[{name}]", got, want, 2 ** -7, 0.0)
            b_ms, b_by = bound(nbytes(x, sin, cos, got))
            rows.append(dict(
                case=name, shape=list(x.shape), strides=list(x.stride()),
                max_abs_err=err, tolerance=tol,
                bitwise=bool(torch.equal(got, want)),
                ms=timer.ms(kernel), plain_ms=timer.ms(plain),
                library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def norm_inputs(dev, gen, rows, dtype):
    """The bench's operands: x and the residual standard normal, weight and
    bias normal (d,) fp32."""
    x = torch.randn(rows, NORM_D, generator=gen, device=dev).to(dtype)
    r = torch.randn(rows, NORM_D, generator=gen, device=dev).to(dtype)
    w = torch.randn(NORM_D, generator=gen, device=dev)
    b = torch.randn(NORM_D, generator=gen, device=dev)
    return x, r, w, b


NORM_CASES = [(rows, torch.float32) for rows in NORM_ROWS] + [
    (NORM_ROWS[-1], torch.bfloat16)]


def check_norm(name, got, want, dtype):
    """new_residual bit for bit (the same fp32 product and sum); normed
    within 1e-5 of its scale in fp32, one bf16 ulp more in bf16 (the row
    sums run in another order)."""
    out, new_res = got
    want_out, want_res = want
    if not torch.equal(new_res, want_res):
        raise AssertionError(f"{name}: new_residual differs from the plain "
                             "version's")
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    return check_close(name, out, want_out, rtol, 1e-5)


def measure_fused_norm(dev, gen, timer):
    """The fused dropout + residual + layernorm kernel at the memory-bound
    bench's cells. Bound: x, residual, weight and bias read once, both
    outputs written once. Yardstick: F.layer_norm of the summed residual
    (precomputed, not timed), which leaves out the dropout, the add and
    the residual output."""
    rows_out = []
    for rows, dtype in NORM_CASES:
        x, r, w, b = norm_inputs(dev, gen, rows, dtype)
        kw = dict(dropout_p=NORM_P)

        def kernel():
            return dropout_residual_layernorm(x, r, w, b, NORM_SEED, **kw)

        def plain():
            return fused_dropout_residual_layernorm_ref(x, r, w, b, NORM_SEED,
                                                        **kw)

        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        name = f"rows{rows}_{str(dtype).split('.')[-1]}"
        err, tol = check_norm(f"fused_norm[{name}]", got, want, dtype)
        b_ms, b_by = bound(nbytes(x, r, w, b, *got))
        summed = r + x
        wl, bl = w.to(dtype), b.to(dtype)
        rows_out.append(dict(
            case=name, shape=[rows, NORM_D], p=NORM_P, seed=NORM_SEED,
            max_abs_err=err, tolerance=tol, new_residual_bitwise=True,
            ms=timer.ms(kernel), plain_ms=timer.ms(plain),
            library_ms=timer.ms(lambda: F.layer_norm(summed, (NORM_D,), wl,
                                                     bl, 1e-5)),
            library_note="F.layer_norm of the summed residual only",
            bound_ms=b_ms, bound_by=b_by))
        del x, r, summed, got, want
    return rows_out


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------

def no_launches() -> dict:
    return {k.name: 0 for k in kernels.KERNELS}


def expected_launches(cfg, batches: int, qkv_plan: str = "rope_fused") -> dict:
    """Per layer and served batch: the prefill's fused GEMMs (4 on rungs 1
    and 2; 2 on rung 3, whose projections are plain products) and one flash
    prefill, 2 fused GEMMs and one decode kernel per decode step; on rungs
    2 and 3 the RoPE kernel for the prefill's q and k (decode rotates its
    token with the plain version)."""
    steps = NEW_TOKENS - 1                     # decode calls per batch
    n = batches * cfg.num_layers
    prefill_gemms = 2 if qkv_plan == "unfused" else 4
    want = {**no_launches(), "gemm_fused": n * (prefill_gemms + 2 * steps),
            "flash_attention_fwd": n, "flash_decode": n * steps}
    if qkv_plan != "rope_fused":
        want["rope"] = 2 * n
    return want


def teacher_forced_logits(model, params, tokens):
    """Per-step logits (BATCH, V) fp32 of ``tokens`` (B, PROMPT + NEW):
    prefill the prompt, then decode the given tokens one by one."""
    out = []
    with torch.inference_mode():
        cache = model.init_cache(tokens.shape[0], MAX_LEN)
        cache, logits = model.prefill(params, tokens[:, :PROMPT], cache)
        out.append(logits.float())
        for i in range(NEW_TOKENS - 1):
            cache, logits = model.decode_step(
                params, tokens[:, PROMPT + i:PROMPT + i + 1], cache, PROMPT + i)
            out.append(logits.float())
    return out


@dataclasses.dataclass
class Models:
    """llama-1b at full width with seeded random weights, three ways: the
    kernel path (bf16), the plain path (bf16) and the plain fp32 truth."""
    cfg: object
    kernel: object
    plain: object
    truth: object
    params: dict
    params32: dict


def build_models(dev) -> Models:
    cfg = get_config("llama-1b")
    t0 = time.perf_counter()
    model = build_model(cfg, mode="kernel", device=dev)
    params = model.init(seed=0)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    m = Models(cfg, model, build_model(cfg, mode="reference", device=dev),
               build_model(cfg32, mode="reference", device=dev), params,
               tree_map(lambda x: x.float(), params))
    torch.cuda.synchronize()
    log(f"[slice] llama-1b built: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; init "
        f"{time.perf_counter() - t0:.1f} s")
    return m


def check_logit_bound(name, kern, plain, truth):
    """Each step's kernel-path logits no further from fp32 than 2x the plain
    bf16 path's distance + 1e-2; returns the largest share of the bound
    used and the greedy agreement with the plain path."""
    worst = 0.0
    agree = 0
    for i, (k, p, t) in enumerate(zip(kern, plain, truth)):
        k_err = (k - t).abs().max().item()
        p_err = (p - t).abs().max().item()
        if not k_err <= 2.0 * p_err + 1e-2:
            raise AssertionError(f"{name} step {i}: kernel path logits are "
                                 f"{k_err:.4g} from fp32, plain bf16 path "
                                 f"{p_err:.4g}")
        worst = max(worst, k_err / (2.0 * p_err + 1e-2))
        agree += int((k.argmax(-1) == p.argmax(-1)).sum())
    return worst, agree / sum(k.numel() // k.shape[-1] for k in kern)


def run_slice(dev, m: Models, model=None, tag: str = "slice"):
    """Phase 4 (``m.kernel``) or 7a (``model``, another rung of the QKV
    ladder): serve, check the launches and the served streams, then hold the
    teacher-forced logits of the first batch to the fp32 truth."""
    cfg, params = m.cfg, m.params
    model = model or m.kernel
    engine = Engine(model, params, max_len=MAX_LEN)
    rng = np.random.default_rng(0)
    # one warm-up batch of the served shape (cuBLAS handles, allocator)
    engine.generate(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)), 2)
    engine.timings.clear()

    queue = RequestQueue(engine, batch_size=BATCH, buckets=(PROMPT,))
    reqs = [Request(uid, rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(128, PROMPT + 1)))
                    .astype(np.int32), NEW_TOKENS)
            for uid in range(REQUESTS)]
    for r in reqs:
        queue.submit(r)
    kernels.reset_launch_counts()
    served = queue.flush(force=True)
    counts = kernels.launch_counts()
    log(f"[{tag}] served {served} requests; launches {counts}")
    want = expected_launches(cfg, REQUESTS // BATCH, model.qkv_plan)
    if served != REQUESTS or counts != want:
        raise AssertionError(f"served {served}, launches {counts}; the main "
                             f"path makes {want}")
    for r in reqs:
        check_result(cfg, r, queue.results[r.uid])
    pre_tok = sum(t["batch"] * t["prompt_len"] for t in engine.timings)
    pre_s = sum(t["prefill_s"] for t in engine.timings)
    dec_tok = sum(t["batch"] * (t["new_tokens"] - 1) for t in engine.timings)
    dec_s = sum(t["decode_s"] for t in engine.timings)
    throughput = {"prefill_tokens_per_s": pre_tok / pre_s,
                  "decode_tokens_per_s": dec_tok / dec_s,
                  "prefill_s": pre_s, "decode_s": dec_s}
    log(f"[{tag}] prefill {pre_tok} tokens in {pre_s:.4f} s "
        f"({throughput['prefill_tokens_per_s']:.1f} tok/s); decode "
        f"{dec_tok} tokens in {dec_s:.4f} s "
        f"({throughput['decode_tokens_per_s']:.1f} tok/s)")

    # teacher forcing on the first served batch
    first = reqs[:BATCH]
    tokens = torch.tensor(np.stack([
        np.pad(queue.results[r.uid], (PROMPT - len(r.prompt), 0))
        for r in first]), dtype=torch.int64, device=dev)
    kern = teacher_forced_logits(model, params, tokens)
    greedy = torch.stack([lg.argmax(-1) for lg in kern], dim=1)
    if not torch.equal(greedy, tokens[:, PROMPT:]):
        raise AssertionError("the served greedy tokens differ from the "
                             "argmax of the kernel path's teacher-forced "
                             "logits")
    plain = teacher_forced_logits(m.plain, params, tokens)
    truth = teacher_forced_logits(m.truth, m.params32, tokens)
    worst, agreement = check_logit_bound(tag, kern, plain, truth)
    log(f"[{tag}] teacher-forced logits over {len(kern)} steps: kernel-path "
        f"error vs fp32 at most {worst:.3f} of its bound (2 x plain bf16 "
        f"error + 1e-2); greedy agreement with the plain bf16 path "
        f"{agreement:.3f} (information only)")
    return {"served": served, "launches": counts, "throughput": throughput,
            "logit_bound_use": worst, "greedy_agreement": agreement,
            "teacher_forced": (tokens, plain, truth)}


def check_result(cfg, req, row):
    if row.shape != (len(req.prompt) + req.max_new_tokens,) or \
            not ((row >= 0) & (row < cfg.vocab_size)).all() or \
            not np.array_equal(row[: len(req.prompt)], req.prompt):
        raise AssertionError(f"request {req.uid}: bad result {row}")


# ---------------------------------------------------------------------------
# Phase 5: the paged slice
# ---------------------------------------------------------------------------

PHASES = {
    # pool pressure: 32 usable pages for 8 slots of up to 6 pages each
    "5a": dict(n_pages=33),
    "5b": dict(prefix_cache=True, chunk_tokens=CHUNK),
}


def paged_requests(cfg, phase: str) -> list:
    """5a: 16 requests, prompts of 96-320 tokens, 16-64 new tokens. 5b: 12
    requests sharing a 192-token (3-page) prefix plus 32-160 tokens of
    their own, 16-64 new tokens. Seeded, greedy."""
    v = cfg.vocab_size
    if phase == "5a":
        rng = np.random.default_rng(0)
        return [Request(u, rng.integers(0, v, int(rng.integers(96, 321)))
                        .astype(np.int32), int(rng.integers(16, 65)))
                for u in range(16)]
    rng = np.random.default_rng(1)
    head = rng.integers(0, v, 3 * PAGE).astype(np.int32)
    return [Request(u, np.concatenate(
        [head, rng.integers(0, v, int(rng.integers(32, 161)))
         .astype(np.int32)]), int(rng.integers(16, 65))) for u in range(12)]


def expected_paged_launches(cfg, engine) -> dict:
    """What the engine's own counters imply: per layer, a prefill or chunk
    runs 4 fused GEMMs (q|k, v, SwiGLU up, down) and a decode step 2 (the
    MLP); flash prefill per exact-length prefill, the paged kernel per
    decode step and per chunk."""
    n = cfg.num_layers
    pre, chunks, steps = (engine.prefills, engine.chunks_prefilled,
                          engine.decode_steps)
    return {**no_launches(),
            "gemm_fused": n * (4 * (pre + chunks) + 2 * steps),
            "flash_attention_fwd": n * pre,
            "flash_decode_paged": n * (steps + chunks)}


def paged_replay(engine, model, params, row, plen: int, chunk, dev):
    """Teacher-forced logits (fp32, one (V,) row per served token) of one
    served stream in a lone slot of a SLOTS-row table: the engine's route
    (exact-length prefill, or ``chunk``-token chunks), then one decode step
    per served token over the table sliced to the page bucket ``engine``
    gives that slot alone."""
    n_pages = kvc.num_pages_needed(len(row), PAGE)
    cache = model.init_paged_cache(SLOTS, n_pages + 1, PAGE)
    state = kvc.init_page_state(SLOTS, MAX_PAGES)
    kvc.assign_slot(state, 0, list(range(1, n_pages + 1)), plen)
    row64 = np.asarray(row, np.int64)
    out = []
    with torch.inference_mode():
        if chunk is None:
            cache, logits = model.prefill_paged(
                params, torch.as_tensor(row64[None, :plen], device=dev),
                cache, state["page_table"][0], 0, plen)
        else:
            for start in range(0, plen, chunk):
                end = min(plen, start + chunk)
                toks = np.zeros((1, chunk), np.int64)
                toks[0, : end - start] = row64[start:end]
                cache, logits = model.prefill_paged_chunk(
                    params, torch.as_tensor(toks, device=dev), cache,
                    state["page_table"][0], start,
                    plen - 1 - start if end == plen else 0)
        out.append(logits[0].float())
        for length in range(plen, len(row) - 1):
            # the slot holds the pages of length + 1 tokens (grown just in
            # time before the step)
            bucket = engine.page_bucket(kvc.num_pages_needed(length + 1, PAGE))
            tokens = np.zeros((SLOTS, 1), np.int64)
            tokens[0, 0] = row64[length]
            lengths = np.zeros((SLOTS,), np.int32)
            lengths[0] = length
            cache, logits = model.decode_step_paged(
                params, torch.as_tensor(tokens, device=dev), cache,
                state["page_table"][:, :bucket], lengths)
            out.append(logits[0].float())
    return out


def run_paged_phase(dev, m: Models, phase: str) -> dict:
    cfg = m.cfg
    kw = dict(batch_slots=SLOTS, page_size=PAGE, max_pages_per_seq=MAX_PAGES,
              **PHASES[phase])
    chunk = kw.get("chunk_tokens")
    # warm-up of the same route (cuBLAS plans at the decode shapes)
    warm = PagedEngine(m.kernel, m.params, **kw)
    for u in range(2):
        warm.submit(Request(u, np.arange(1, 100 + u, dtype=np.int32), 3))
    warm.run()

    engine = PagedEngine(m.kernel, m.params, **kw)
    reqs = paged_requests(cfg, phase)
    for r in reqs:
        engine.submit(r)
    kernels.reset_launch_counts()
    results = engine.run()
    counts = kernels.launch_counts()
    rep = engine.report()
    want = expected_paged_launches(cfg, engine)
    log(f"[{phase}] served {len(results)} requests in {rep['steps']} steps: "
        f"{rep['prefills']} exact prefills, {engine.chunks_prefilled} chunks, "
        f"{rep['decode_steps']} decode steps, {rep['preemptions']} "
        f"preemptions, peak {rep['peak_pages_in_use']} of "
        f"{rep['page_pool_size']} pages; launches {counts}")
    if counts != want:
        raise AssertionError(f"[{phase}] launches {counts}; the engine's "
                             f"counters imply {want}")
    path = ("gemm_fused", "flash_decode_paged") + (
        ("flash_attention_fwd",) if phase == "5a" else ())
    if not all(counts[k] > 0 for k in path):
        raise AssertionError(f"[{phase}] a kernel of the path never ran")
    if sorted(results) != [r.uid for r in reqs]:
        raise AssertionError(f"[{phase}] completed {sorted(results)}")
    for r in reqs:
        check_result(cfg, r, results[r.uid])
    held = rep.get("prefix_cache", {}).get("pages_held", 0)
    if engine.alloc.free_pages != engine.n_pages - 1 - held:
        raise AssertionError(f"[{phase}] {engine.alloc.free_pages} pages "
                             f"free, {held} held by the trie, of "
                             f"{engine.n_pages - 1}")
    if phase == "5a" and rep["preemptions"] < 1:
        raise AssertionError("[5a] the pool never forced a preemption")
    if phase == "5b":
        if rep["prefix_cache"]["hits"] < 1 or engine.chunks_prefilled < 1:
            raise AssertionError(f"[5b] prefix hits "
                                 f"{rep['prefix_cache']['hits']}, chunks "
                                 f"{engine.chunks_prefilled}")
        log(f"[5b] prefix cache {rep['prefix_cache']}")
    t = rep["timings"]
    throughput = {"prefill_tokens_per_s": t["prefill_tokens"] / t["prefill_s"],
                  "decode_tokens_per_s": t["decode_tokens"] / t["decode_s"],
                  **t}
    log(f"[{phase}] prefill {t['prefill_tokens']} tokens in "
        f"{t['prefill_s']:.4f} s ({throughput['prefill_tokens_per_s']:.1f} "
        f"tok/s); decode {t['decode_tokens']} tokens in {t['decode_s']:.4f} s "
        f"({throughput['decode_tokens_per_s']:.1f} tok/s)")

    # preempted or prefix-matched streams take another route: not replayed
    other_route = set(rep["preempted_uids"]) | set(
        rep.get("prefix_cache", {}).get("hit_uids", ()))
    replayed = [r for r in reqs if r.uid not in other_route][:2]
    if len(replayed) < 2:
        raise AssertionError(f"[{phase}] fewer than two requests kept the "
                             "plain route")
    kern, plain, truth = [], [], []
    for r in replayed:
        row, plen = results[r.uid], len(r.prompt)
        k = paged_replay(engine, m.kernel, m.params, row, plen, chunk, dev)
        greedy = np.array([int(x.argmax()) for x in k])
        if not np.array_equal(greedy, row[plen:]):
            raise AssertionError(f"[{phase}] request {r.uid}: the lone-slot "
                                 "replay's greedy tokens differ from the "
                                 "served ones")
        kern += k
        plain += paged_replay(engine, m.plain, m.params, row, plen, chunk,
                              dev)
        truth += paged_replay(engine, m.truth, m.params32, row, plen, chunk,
                              dev)
    worst, agreement = check_logit_bound(phase, kern, plain, truth)
    log(f"[{phase}] replayed requests {[r.uid for r in replayed]} in a lone "
        f"slot: greedy tokens equal the served ones over {len(kern)} steps; "
        f"kernel-path error vs fp32 at most {worst:.3f} of its bound; "
        f"greedy agreement with the plain bf16 path {agreement:.3f} "
        f"(information only)")
    return {"report": rep, "launches": counts, "throughput": throughput,
            "replayed": [r.uid for r in replayed],
            "logit_bound_use": worst, "greedy_agreement": agreement}


# ---------------------------------------------------------------------------
# Phase 6: training
# ---------------------------------------------------------------------------

def expected_train_launches(cfg, steps: int) -> dict:
    """Per layer and step under remat_policy='full': the forward's 4 fused
    GEMMs and flash forward, again in the backward's recompute, then for
    each GEMM its backward's operand pass, dA and dB (4 each), and the
    flash backward's two launches (the main kernel and the dq
    conversion)."""
    n = cfg.num_layers * steps
    return {**no_launches(), "gemm_fused": 8 * n, "flash_attention_fwd": 2 * n,
            "gemm_bwd_g": 4 * n, "gemm_bwd_da": 4 * n, "gemm_bwd_db": 4 * n,
            "flash_attention_bwd": 2 * n}


def train_data(cfg, dev):
    return DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH), device=dev)


def trained_scale(model, params) -> dict:
    """The seeded weights rescaled to std fan_in^-1/2 over each matrix's
    input dim (the tied embedding's over d_model). The reference's init
    draws a stacked matrix at std (layers)^-1/2: 0.71 at 2 layers, where
    the bf16 grads of every path are rounding noise as large as the grads
    themselves."""
    out = {}
    for path, x in named_leaves(params):
        d = model.defs[path]
        if d.init == "normal" and len(d.shape) > 1:
            fan = d.shape[-1] if path == "embed" else d.shape[-2]
            x = x * (d.shape[0] / fan) ** 0.5
        out[path] = x
    return nest(out)


def run_grad_check(dev) -> dict:
    """Phase 6a: per-leaf grads of lm_loss at llama-1b widths, 2 layers."""
    cfg = dataclasses.replace(get_config("llama-1b"), num_layers=2)
    batch = next(train_data(cfg, dev))

    def grads(mode, dtype):
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                            mode=mode, device=dev)
        params = tree_map(lambda t: t.requires_grad_(), trained_scale(
            model, model.init(seed=0, dtype=cfg.param_dtype)))
        kernels.reset_launch_counts()
        loss, _, g = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        named = {path: x.float() for (path, _), x
                 in zip(named_leaves(params), g)}
        return float(loss), named, kernels.launch_counts()

    k_loss, kern, counts = grads("kernel", "bfloat16")
    want = expected_train_launches(cfg, 1)
    if counts != want:
        raise AssertionError(f"[6a] launches {counts}; one step of "
                             f"{cfg.num_layers} layers makes {want}")
    p_loss, plain, _ = grads("reference", "bfloat16")
    t_loss, truth, _ = grads("reference", "float32")
    worst, per_leaf = 0.0, {}
    for path, t_ in truth.items():
        k_, p_ = kern[path], plain[path]
        k_err = (k_ - t_).abs().max().item()
        p_err = (p_ - t_).abs().max().item()
        per_leaf[path] = {"kernel_err": k_err, "plain_err": p_err,
                          "truth_max": t_.abs().max().item()}
        if not k_err <= 2.0 * p_err + 1e-3:
            raise AssertionError(f"[6a] {path}: kernel-mode grad {k_err:.4g} "
                                 f"from fp32, plain bf16 {p_err:.4g}")
        worst = max(worst, k_err / (2.0 * p_err + 1e-3))
    log(f"[6a] llama-1b widths, {cfg.num_layers} layers, weights at std "
        f"fan_in^-1/2, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens: loss kernel {k_loss:.5f}, plain bf16 "
        f"{p_loss:.5f}, fp32 {t_loss:.5f}; every one of {len(truth)} leaves' "
        f"kernel-mode grad error within its bound (2 x plain bf16 error + "
        f"1e-3), at most {worst:.3f} of it")
    return {"losses": {"kernel": k_loss, "plain": p_loss, "truth": t_loss},
            "launches": counts, "bound_use": worst, "leaves": per_leaf}


def train_curve(cfg, mode, dtype, dev, steps: int = TRAIN_STEPS,
                qkv_plan: str = "rope_fused") -> dict:
    """``steps`` steps of train_loop from seed 0 on the ported data, on the
    schedule of a TRAIN_STEPS-step run."""
    model = build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                        mode=mode, device=dev, qkv_plan=qkv_plan)
    opt = AdamWConfig(schedule=cosine_schedule(TRAIN_LR, 2, TRAIN_STEPS))
    data = train_data(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = train_loop(model, data, steps, opt, seed=0, log_every=0)
    counts = kernels.launch_counts()
    out = {"losses": res.losses, "step_seconds": res.step_seconds,
           "launches": counts,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del res
    torch.cuda.empty_cache()
    return out


def run_training(dev) -> dict:
    """Phase 6b: all 16 layers of llama-1b, kernel mode, through
    train_loop; then the plain bf16 and fp32 curves of the same steps."""
    cfg = get_config("llama-1b")
    kern = train_curve(cfg, "kernel", "bfloat16", dev)
    want = expected_train_launches(cfg, TRAIN_STEPS)
    losses = kern["losses"]
    step_s = statistics.median(kern["step_seconds"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[6b] llama-1b, {cfg.num_layers} layers, remat "
        f"{cfg.remat_policy!r}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in kernel mode: losses "
        f"{[round(x, 4) for x in losses]}; launches {kern['launches']}")
    if kern["launches"] != want:
        raise AssertionError(f"[6b] launches {kern['launches']}; "
                             f"{TRAIN_STEPS} steps of the model make {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[6b] losses {losses}: not finite and falling")
    log(f"[6b] step time {step_s:.4f} s (median of the steps after the "
        f"first), {tokens / step_s:.1f} tokens/s; peak device memory "
        f"{kern['peak_memory_gb']:.2f} GB")
    plain = train_curve(cfg, "reference", "bfloat16", dev)
    truth = train_curve(cfg, "reference", "float32", dev)
    k_err = float(np.abs(np.subtract(losses, truth["losses"])).max())
    p_err = float(np.abs(np.subtract(plain["losses"], truth["losses"])).max())
    log(f"[6b] plain bf16 losses {[round(x, 4) for x in plain['losses']]}; "
        f"fp32 {[round(x, 4) for x in truth['losses']]}; the kernel curve is "
        f"{k_err:.4g} from fp32, the plain bf16 curve {p_err:.4g} (bound "
        f"2.5 x {p_err:.4g} + 0.05)")
    if not k_err <= 2.5 * p_err + 0.05:
        raise AssertionError(f"[6b] kernel curve {k_err:.4g} from the fp32 "
                             f"truth, plain bf16 {p_err:.4g}")
    prof = profile_step(build_model(cfg, mode="kernel", device=dev),
                        TRAIN_BATCH, TRAIN_SEQ, warmup=1)
    tr = prof["traced"]
    log(f"[6b] one traced step: device busy {tr['device_busy_ms']:.1f} of "
        f"{tr['traced_wall_ms']:.1f} ms ({tr['device_busy_share']:.3f}); "
        f"device ms by family "
        f"{ {k: round(v, 2) for k, v in tr['device_ms_by_family'].items()} }")
    return {"launches": kern["launches"], "kernel": kern, "plain": plain,
            "truth": truth, "curve_err": {"kernel": k_err, "plain": p_err},
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "profile": prof}


# ---------------------------------------------------------------------------
# Phase 7: the ladder's standalone-RoPE rungs and the fused norm op
# ---------------------------------------------------------------------------

def run_ladder_serve(dev, m: Models) -> dict:
    """7a: phase 4's traffic on rung 2 (``qkv_plan="norm_fused"``); 7c: one
    teacher-forced pass of 7a's first batch on rung 3 (``"unfused"``), held
    to the fp32 truth under 7a's bound."""
    rung2 = build_model(m.cfg, mode="kernel", device=dev,
                        qkv_plan="norm_fused")
    out = {"7a": run_slice(dev, m, rung2, tag="7a")}
    tokens, plain, truth = out["7a"].pop("teacher_forced")
    rung3 = build_model(m.cfg, mode="kernel", device=dev, qkv_plan="unfused")
    kernels.reset_launch_counts()
    kern = teacher_forced_logits(rung3, m.params, tokens)
    counts = kernels.launch_counts()
    want = expected_launches(m.cfg, 1, "unfused")
    if counts != want:
        raise AssertionError(f"[7c] launches {counts}; one teacher-forced "
                             f"batch on rung 3 makes {want}")
    worst, agreement = check_logit_bound("7c", kern, plain, truth)
    log(f"[7c] qkv_plan 'unfused', teacher-forced logits over {len(kern)} "
        f"steps: error vs fp32 at most {worst:.3f} of its bound (2 x plain "
        f"bf16 error + 1e-2); launches {counts}")
    out["7c"] = {"launches": counts, "logit_bound_use": worst,
                 "greedy_agreement": agreement}
    return out


def run_ladder_train(dev, curves: dict) -> dict:
    """7b: the first LADDER_STEPS steps of 6b's run (same data, seed and
    schedule) on rung 2, held to 6b's fp32 curve over those steps under
    6b's bound, against the plain bf16 curve's distance."""
    cfg = get_config("llama-1b")
    run = train_curve(cfg, "kernel", "bfloat16", dev, steps=LADDER_STEPS,
                      qkv_plan="norm_fused")
    n = cfg.num_layers * LADDER_STEPS
    want = {**expected_train_launches(cfg, LADDER_STEPS), "rope": 6 * n}
    losses = run["losses"]
    log(f"[7b] qkv_plan 'norm_fused', {LADDER_STEPS} steps: losses "
        f"{[round(x, 4) for x in losses]}; launches {run['launches']}")
    if run["launches"] != want:
        raise AssertionError(f"[7b] launches {run['launches']}; "
                             f"{LADDER_STEPS} steps on rung 2 make {want}")
    truth = curves["truth"]["losses"][:LADDER_STEPS]
    plain = curves["plain"]["losses"][:LADDER_STEPS]
    k_err = float(np.abs(np.subtract(losses, truth)).max())
    p_err = float(np.abs(np.subtract(plain, truth)).max())
    log(f"[7b] the rung-2 curve is {k_err:.4g} from 6b's fp32 curve over "
        f"these steps, the plain bf16 curve {p_err:.4g} (bound 2.5 x "
        f"{p_err:.4g} + 0.05); step time "
        f"{statistics.median(run['step_seconds'][1:]):.4f} s")
    if not all(np.isfinite(losses)) or not k_err <= 2.5 * p_err + 0.05:
        raise AssertionError(f"[7b] losses {losses}: {k_err:.4g} from the "
                             f"fp32 truth, plain bf16 {p_err:.4g}")
    return {**run, "curve_err": {"kernel": k_err, "plain": p_err}}


def run_norm_op(dev) -> dict:
    """7d: dropout_residual_layernorm through the public op at the bench's
    cells: the outputs against the plain version, and the kernel's
    keep-mask bit for bit the plain one's, read from a probe call with
    x = 1 and residual = 0 (new_residual is the scale where a lane is kept,
    0 where it is dropped)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    kernels.reset_launch_counts()
    calls, cases = 0, []
    for rows, dtype in NORM_CASES:
        x, r, w, b = norm_inputs(dev, gen, rows, dtype)
        got = dropout_residual_layernorm(x, r, w, b, NORM_SEED,
                                         dropout_p=NORM_P)
        ones = torch.ones_like(x)
        _, probe = dropout_residual_layernorm(ones, torch.zeros_like(x), w, b,
                                              NORM_SEED, dropout_p=NORM_P)
        calls += 2
        torch.cuda.synchronize()
        name = f"rows{rows}_{str(dtype).split('.')[-1]}"
        err, _ = check_norm(f"[7d] {name}", got, fused_dropout_residual_layernorm_ref(
            x, r, w, b, NORM_SEED, dropout_p=NORM_P), dtype)
        keep = dropout_keep_mask_ref(NORM_SEED, x.shape, NORM_P, dev)
        if not torch.equal(probe != 0, keep):
            raise AssertionError(f"[7d] {name}: the kernel's keep-mask "
                                 "differs from the plain version's")
        cases.append({"case": name, "max_abs_err": err,
                      "kept_share": keep.float().mean().item()})
        del x, r, got, ones, probe, keep
    counts = kernels.launch_counts()
    if counts != {**no_launches(), "fused_norm": calls}:
        raise AssertionError(f"[7d] launches {counts}; {calls} calls made")
    log(f"[7d] dropout_residual_layernorm at {len(cases)} bench cells: "
        f"outputs within tolerance, keep-masks bit for bit the plain ones "
        f"{[(c['case'], round(c['kept_share'], 4)) for c in cases]}; "
        f"launches {counts}")
    return {"launches": counts, "cases": cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report to OUT/chip_smoke.json")
    ap.add_argument("--baseline-csrc", default=None,
                    help="an earlier tree's csrc directory: time its "
                    "forward GEMM, GEMM backward (dA + dB) and flash "
                    "backward in turns with this one's")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build_logs = kernels.build_all()
    log(f"[build] {len(kernels.KERNELS)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in str(text).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    build_model(get_config("llama-1b"), device=dev)   # pins fp32 numerics
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)
    cfg = get_config("llama-1b")
    old = baseline_kernels(args.baseline_csrc) if args.baseline_csrc else None
    measured = {"gemm_fused": measure_gemm(cfg, dev, gen, timer, old),
                "flash_attention_fwd": measure_flash(cfg, dev, gen, timer),
                "flash_decode": measure_decode(cfg, dev, gen, timer),
                "flash_decode_paged": measure_paged(cfg, dev, gen, timer)}
    bwd_rows, bwd_whole = measure_gemm_bwd(cfg, dev, gen, timer, old)
    measured.update(bwd_rows)
    measured.update({
        "flash_attention_bwd": measure_flash_bwd(cfg, dev, gen, timer, old),
        "rope": measure_rope(cfg, dev, gen, timer),
        "fused_norm": measure_fused_norm(dev, gen, timer)})
    for name, rows in measured.items():
        for r in rows:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.1f} us")
            log(f"[kernel] {name}[{r['case']}] shape {r['shape']}: max abs "
                f"err {r['max_abs_err']:.4g} ({r['tolerance']}); kernel "
                f"{r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
                f"library {lib}, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")

    del timer
    torch.cuda.empty_cache()
    m = build_models(dev)
    phases = {"4": run_slice(dev, m)}
    del phases["4"]["teacher_forced"]
    for phase in PHASES:
        phases[phase] = run_paged_phase(dev, m, phase)
    phases.update(run_ladder_serve(dev, m))
    del m
    torch.cuda.empty_cache()
    phases["6a"] = run_grad_check(dev)
    torch.cuda.empty_cache()
    phases["6b"] = run_training(dev)
    torch.cuda.empty_cache()
    phases["7b"] = run_ladder_train(dev, phases["6b"])
    torch.cuda.empty_cache()
    phases["7d"] = run_norm_op(dev)
    log(f"[done] build and phases 3-7 in {time.perf_counter() - t0:.1f} s")

    line = []
    for name, rows in measured.items():
        b_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        b_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        src, replaces = SOURCES[name]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(phases[p]["launches"][name]
                            for p in MAIN_PATH_PHASES),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ops + b_bytes,
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            # no one PyTorch call computes RoPE
            "library_ms": (None if any(r["library_ms"] is None for r in rows)
                           else sum(r["library_ms"] for r in rows)),
            "cases": rows})
    report = {"device": card, "kernels": line, "phases": phases,
              "gemm_bwd_whole": bwd_whole}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
