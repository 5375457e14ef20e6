"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--out DIR]

Phases, each of which raises on failure (exit code non-zero):

1. Device: refuse to run without CUDA; print the card's name and power
   limit as nvidia-smi gives them.
2. Build: compile the three CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, in parallel); print the build time and what
   ptxas reports for each kernel.
3. Kernels: each kernel against its plain torch version on the card, at the
   llama-1b main-path shapes (prefill B 4, S 256, so M = 1024; decode B 4
   over a 296-slot cache), with the stated tolerance; kernel, plain and
   library times with CUDA events (L2 scrubbed before every launch), and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   989 TFLOP/s bf16 / 67 TFLOP/s fp32, whichever is larger).
4. The slice: llama-1b at full width with seeded random weights, 8 requests
   (prompts of 128-256 tokens, 32 new tokens, greedy) through
   ``RequestQueue(Engine(...), batch_size=4, buckets=(256,))`` in kernel
   mode; every kernel launch counter is zeroed just before and read just
   after, and must equal the launches the path makes. Then teacher forcing:
   the served token streams go through the kernel path, the plain bf16 path
   and the plain fp32 path; the kernel path's per-step logits must be no
   further from fp32 than 2x the plain bf16 path's distance + 1e-2.
5. One JSON line of per-kernel numbers, the nvidia-smi line, and the last
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
    BLOCK_KV, combine_splits, decode_partials_ref, flash_attention_fwd,
    flash_attention_fwd_ref, flash_decode)
from repro_torch.kernels.gemm import (Epilogue, Prologue, gemm_fused,  # noqa: E402
                                      gemm_fused_ref)
from repro_torch.kernels.rope import rope_tables  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve import Engine, Request, RequestQueue  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12      # outside the tensor cores
HBM_BYTES_S = 3.35e12

BATCH, PROMPT, NEW_TOKENS, REQUESTS = 4, 256, 32, 8
MAX_LEN = PROMPT + NEW_TOKENS + 8          # as the serving launcher sizes it

SOURCES = {
    "gemm_fused": ("src/repro_torch/kernels/csrc/gemm_fused.cu",
                   "src/repro/kernels/gemm/kernel.py:84"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                            "src/repro/kernels/attention/kernel_fwd.py:45"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/attention/kernel_decode.py:109"),
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


def bound(flops: float, bytes_: float, peak: float) -> tuple:
    t_ops, t_bytes = flops / peak * 1e3, bytes_ / HBM_BYTES_S * 1e3
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
        b_ms, b_by = bound(flops, traffic, PEAK_BF16)
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
    flops = 4 * pairs * hd
    traffic = nbytes(q, k, v, out, lse)
    b_ms, b_by = bound(flops, traffic, PEAK_BF16)
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
    flops = 4 * BATCH * h * length * hd
    b_ms, b_by = bound(flops, traffic, PEAK_FP32)
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


def run_slice(dev):
    cfg = get_config("llama-1b")
    t0 = time.perf_counter()
    model = build_model(cfg, mode="kernel", device=dev)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    log(f"[slice] llama-1b built: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; init "
        f"{time.perf_counter() - t0:.1f} s")
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
    if served != REQUESTS or counts != want:
        raise AssertionError(f"served {served}, launches {counts}; the main "
                             f"path makes {want}")
    for r in reqs:
        row = queue.results[r.uid]
        if row.shape != (len(r.prompt) + NEW_TOKENS,) or \
                not ((row >= 0) & (row < cfg.vocab_size)).all() or \
                not np.array_equal(row[: len(r.prompt)], r.prompt):
            raise AssertionError(f"request {r.uid}: bad result {row}")
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
    plain = teacher_forced_logits(build_model(cfg, mode="reference",
                                              device=dev), params, tokens)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    truth = teacher_forced_logits(build_model(cfg32, mode="reference",
                                              device=dev),
                                  tree_map(lambda x: x.float(), params),
                                  tokens)
    worst = 0.0
    agree = 0
    for i, (k, p, t) in enumerate(zip(kern, plain, truth)):
        k_err = (k - t).abs().max().item()
        p_err = (p - t).abs().max().item()
        if not k_err <= 2.0 * p_err + 1e-2:
            raise AssertionError(f"step {i}: kernel path logits are {k_err:.4g}"
                                 f" from fp32, plain bf16 path {p_err:.4g}")
        worst = max(worst, k_err / (2.0 * p_err + 1e-2))
        agree += int((k.argmax(-1) == p.argmax(-1)).sum())
    agreement = agree / (len(kern) * BATCH)
    log(f"[slice] teacher-forced logits over {len(kern)} steps: kernel-path "
        f"error vs fp32 at most {worst:.3f} of its bound (2 x plain bf16 "
        f"error + 1e-2); greedy agreement with the plain bf16 path "
        f"{agreement:.3f} (information only)")
    return {"served": served, "launches": counts, "throughput": throughput,
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
                "flash_decode": measure_decode(cfg, dev, gen, timer)}
    for name, rows in measured.items():
        for r in rows:
            log(f"[kernel] {name}[{r['case']}] shape {r['shape']}: max abs "
                f"err {r['max_abs_err']:.4g} ({r['tolerance']}); kernel "
                f"{r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
                f"library {r['library_ms'] * 1e3:.1f} us, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")

    slice_report = run_slice(dev)

    line = []
    for name, rows in measured.items():
        b_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        b_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        src, replaces = SOURCES[name]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": slice_report["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ops + b_bytes,
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
            "cases": rows})
    report = {"device": card, "kernels": line, "slice": slice_report}
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
