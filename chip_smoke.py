"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--out DIR]

Phases, each of which raises on failure (exit code non-zero):

1. Device: refuse to run without CUDA; print the card's name and power
   limit as nvidia-smi gives them.
2. Build: compile the four CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, in parallel); print the build time and what
   ptxas reports for each kernel.
3. Kernels: each kernel against its plain torch version on the card, at the
   llama-1b main-path shapes (prefill B 4, S 256, so M = 1024; decode B 4
   over a 296-slot cache; paged decode over 8 slots of an 8-page bucket of
   a 65-page pool, a 128-token chunk at position 192 and a 4-token verify),
   with the stated tolerance; kernel, plain and library times with CUDA
   events (L2 scrubbed before every launch), and the least time the card
   could take (bytes over 3.35 TB/s or operations over their peak,
   whichever is larger: products of two bf16 operands at 989 TFLOP/s, those
   with an fp32 operand, such as the softmax weights of p @ v, at 67
   TFLOP/s). The paged kernel at page 64 and
   one query token must equal ``flash_decode`` over the gathered pages bit
   for bit. No PyTorch call computes paged attention: its yardstick is
   ``F.scaled_dot_product_attention`` over the pre-gathered cache, the
   gather not timed.
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
6. One JSON line of per-kernel numbers, the nvidia-smi line, and the last
   line ``{"ok": true, "device": {...}}``.

``--out DIR`` also writes the full report to ``DIR/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
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
from repro_torch.kernels.attention import (  # noqa: E402
    BLOCK_KV, combine_splits, decode_partials_paged_ref, decode_partials_ref,
    flash_attention_fwd, flash_attention_fwd_ref, flash_decode,
    flash_decode_paged)
from repro_torch.kernels.gemm import (Epilogue, Prologue, gemm_fused,  # noqa: E402
                                      gemm_fused_ref)
from repro_torch.kernels.rope import rope_tables  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve import (Engine, PagedEngine, Request,  # noqa: E402
                               RequestQueue)
from repro_torch.serve import kv_cache as kvc  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12      # outside the tensor cores
HBM_BYTES_S = 3.35e12

BATCH, PROMPT, NEW_TOKENS, REQUESTS = 4, 256, 32, 8
MAX_LEN = PROMPT + NEW_TOKENS + 8          # as the serving launcher sizes it
# the paged slice: PagedEngine geometry and the chunk of phase 5b
SLOTS, PAGE, MAX_PAGES, CHUNK = 8, 64, 8, 128

SOURCES = {
    "gemm_fused": ("src/repro_torch/kernels/csrc/gemm_fused.cu",
                   "src/repro/kernels/gemm/kernel.py:84"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                            "src/repro/kernels/attention/kernel_fwd.py:45"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/attention/kernel_decode.py:109"),
    "flash_decode_paged": ("src/repro_torch/kernels/csrc/flash_decode_paged.cu",
                           "src/repro/kernels/attention/kernel_decode.py:132"),
}


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

    def ms(self, fn) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
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
    down (residual, scale); decode up and down."""
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
    return [
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


def measure_gemm(cfg, dev, gen, timer):
    rows = []
    for name, a, b, kw in gemm_cases(cfg, dev, gen):
        got = gemm_fused(a, b, **kw)
        want = gemm_fused_ref(a, b, **kw)
        torch.cuda.synchronize()
        err, tol = check_close(f"gemm_fused[{name}]", got, want, 2 ** -6, 2e-2)
        m, k = a.shape
        n = b.shape[1]
        gated = "b2" in kw
        # library yardstick: the bare product(s) in one torch.matmul call
        # (no single PyTorch call computes the fused chain)
        b_lib = torch.cat([b, kw["b2"]], dim=1) if gated else b
        flops = 2 * m * n * k * (2 if gated else 1)
        traffic = nbytes(a, b, kw.get("b2"), kw.get("gamma"),
                         kw.get("residual"), kw.get("sin"), kw.get("cos"),
                         got)
        b_ms, b_by = bound(traffic, (flops, PEAK_BF16))
        rows.append(dict(
            case=name, shape=[m, k, n], max_abs_err=err, tolerance=tol,
            ms=timer.ms(lambda: gemm_fused(a, b, **kw)),
            plain_ms=timer.ms(lambda: gemm_fused_ref(a, b, **kw)),
            library_ms=timer.ms(lambda: torch.matmul(a, b_lib)),
            bound_ms=b_ms, bound_by=b_by))
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


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------

def expected_launches(cfg, batches: int) -> dict:
    steps = NEW_TOKENS - 1                     # decode calls per batch
    per_batch_gemm = cfg.num_layers * (4 + 2 * steps)
    return {"gemm_fused": batches * per_batch_gemm,
            "flash_attention_fwd": batches * cfg.num_layers,
            "flash_decode": batches * cfg.num_layers * steps}


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


def run_slice(dev, m: Models):
    cfg, model, params = m.cfg, m.kernel, m.params
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
    log(f"[slice] served {served} requests; launches {counts}")
    want = expected_launches(cfg, REQUESTS // BATCH)
    want["flash_decode_paged"] = 0
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
    log(f"[slice] prefill {pre_tok} tokens in {pre_s:.4f} s "
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
    worst, agreement = check_logit_bound("slice", kern, plain, truth)
    log(f"[slice] teacher-forced logits over {len(kern)} steps: kernel-path "
        f"error vs fp32 at most {worst:.3f} of its bound (2 x plain bf16 "
        f"error + 1e-2); greedy agreement with the plain bf16 path "
        f"{agreement:.3f} (information only)")
    return {"served": served, "launches": counts, "throughput": throughput,
            "logit_bound_use": worst, "greedy_agreement": agreement}


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
    return {"gemm_fused": n * (4 * (pre + chunks) + 2 * steps),
            "flash_attention_fwd": n * pre,
            "flash_decode": 0,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report to OUT/chip_smoke.json")
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
    measured = {"gemm_fused": measure_gemm(cfg, dev, gen, timer),
                "flash_attention_fwd": measure_flash(cfg, dev, gen, timer),
                "flash_decode": measure_decode(cfg, dev, gen, timer),
                "flash_decode_paged": measure_paged(cfg, dev, gen, timer)}
    for name, rows in measured.items():
        for r in rows:
            log(f"[kernel] {name}[{r['case']}] shape {r['shape']}: max abs "
                f"err {r['max_abs_err']:.4g} ({r['tolerance']}); kernel "
                f"{r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
                f"library {r['library_ms'] * 1e3:.1f} us, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")

    del timer
    m = build_models(dev)
    phases = {"4": run_slice(dev, m)}
    for phase in PHASES:
        phases[phase] = run_paged_phase(dev, m, phase)

    line = []
    for name, rows in measured.items():
        b_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        b_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        src, replaces = SOURCES[name]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(p["launches"][name] for p in phases.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ops + b_bytes,
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            "cases": rows})
    report = {"device": card, "kernels": line, "phases": phases}
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
