"""Where the served main path spends its time on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch llama-1b \\
      --batch 4 --prompt-len 256 --new-tokens 32 [--engine paged] --out DIR

Builds the model in kernel mode with seeded random weights, warms it up,
then runs one prefill and the decode steps of one batch twice: once untimed
by the profiler (host clock around work ended by a device synchronise), and
once under ``torch.profiler``. ``--engine fixed`` (the default) drives the
model's prefill and decode step directly, as ``Engine`` does; ``--engine
paged`` drives a ``PagedEngine`` (``--batch`` slots, 64-token pages):
prefill is the admission of every request (one exact-length prefill
each), decode is the engine's steps until all have retired. From the trace
it reports, for prefill and decode apart, the device time by kernel family
(the port's kernels, the library matrix products that the reference also
leaves to the compiler, and the other torch operations), the device's busy
share of the traced window, and the peak device memory. Needs a CUDA card; writes
``DIR/profile_serve_<engine>.json`` and prints one summary line per phase.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import PagedEngine, Request

# kernel name fragment -> family, checked in order
FAMILIES = (
    # the forward GEMM: the rmsnorm row pass, the mainloop (fused epilogue,
    # or split partials) and the split-K reduce
    ("gemm_fused_rows_kernel", "gemm_fused"),
    ("gemm_fused_kernel", "gemm_fused"),
    ("gemm_fused_splitk_kernel", "gemm_fused"),
    ("gemm_fused_reduce_kernel", "gemm_fused"),
    # the GEMM backward: operand pass, dA (GEMM and norm row pass), dB;
    # listed above the catch-all "gemm" below
    ("gemm_bwd_g_", "gemm_bwd_g"),
    ("gemm_bwd_da_kernel", "gemm_bwd_da"),
    ("rms_transpose_kernel", "gemm_bwd_da"),
    ("gemm_bwd_db_kernel", "gemm_bwd_db"),
    # the flash backward: the main kernel and the dq convert pass
    ("flash_bwd_kernel", "flash_attention_bwd"),
    ("flash_bwd_dq_convert_kernel", "flash_attention_bwd"),
    ("flash_fwd_kernel", "flash_attention_fwd"),
    ("flash_decode_paged_kernel", "flash_decode_paged"),
    ("flash_decode_kernel", "flash_decode"),
    ("rope_kernel", "rope"),
    ("fused_norm_kernel", "fused_norm"),
    ("gemm", "library_matmul"),     # cuBLAS / cuBLASLt kernel names
    ("gemv", "library_matmul"),
    ("nvjet", "library_matmul"),
    ("cutlass", "library_matmul"),
    ("xmma", "library_matmul"),
)


def family(name: str) -> str:
    low = name.lower()
    for frag, fam in FAMILIES:
        if frag in low:
            return fam
    return "other_torch"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(prof, wall_s: float) -> dict:
    by_family: dict = {}
    launches: dict = {}
    intervals = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        fam = family(ev.name)
        dur = ev.time_range.elapsed_us()
        by_family[fam] = by_family.get(fam, 0.0) + dur / 1e3
        launches[fam] = launches.get(fam, 0) + 1
        intervals.append((ev.time_range.start, ev.time_range.end))
    busy_ms = _union_us(intervals) / 1e3
    span_ms = ((max(e for _, e in intervals) - min(s for s, _ in intervals))
               / 1e3 if intervals else 0.0)
    return {"device_ms_by_family": by_family,
            "device_launches_by_family": launches,
            "device_busy_ms": busy_ms, "traced_wall_ms": wall_s * 1e3,
            "device_busy_share": busy_ms / (wall_s * 1e3),
            "device_first_to_last_ms": span_ms}


def _timed(fn, profile: bool):
    """(seconds, profiler or None) of ``fn`` ended by a device synchronise."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if not profile:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, None
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, prof


def run_phases(model, params, prompts, new_tokens: int, profile: bool):
    """One prefill and ``new_tokens - 1`` greedy decode steps; returns
    {phase: (seconds, profiler or None)}."""
    cache = model.init_cache(prompts.shape[0], prompts.shape[1] + new_tokens)
    state = {}

    def prefill():
        state["cache"], logits = model.prefill(params, prompts, cache)
        state["tok"] = torch.argmax(logits, dim=-1)[:, None]

    def decode():
        s = prompts.shape[1]
        for i in range(new_tokens - 1):
            state["cache"], logits = model.decode_step(
                params, state["tok"], state["cache"], s + i)
            state["tok"] = torch.argmax(logits, dim=-1)[:, None]

    with torch.inference_mode():
        return {name: _timed(fn, profile)
                for name, fn in (("prefill", prefill), ("decode", decode))}


PAGE = 64


def run_phases_paged(model, params, prompts, new_tokens: int, profile: bool):
    """The same work through a PagedEngine with one slot per prompt: the
    admissions (exact-length prefills), then the engine's steps."""
    b, s = prompts.shape
    pages = -(-(s + new_tokens) // PAGE)
    engine = PagedEngine(model, params, batch_slots=b, page_size=PAGE,
                         max_pages_per_seq=1 << (pages - 1).bit_length())
    for uid, row in enumerate(prompts.cpu().numpy()):
        engine.submit(Request(uid, row.astype(np.int32), new_tokens))

    def decode():
        while engine.step():
            pass

    with torch.inference_mode():
        # _admit is the engine's admission step: every prompt finds a slot
        return {"prefill": _timed(engine._admit, profile),
                "decode": _timed(decode, profile)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=("fixed", "paged"), default="fixed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = build_model(cfg, mode="kernel", device="cuda")
    params = model.init(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        device="cuda")
    run = run_phases_paged if args.engine == "paged" else run_phases
    run(model, params, prompts, 3, profile=False)               # warm-up
    torch.cuda.reset_peak_memory_stats()
    plain = run(model, params, prompts, args.new_tokens, profile=False)
    traced = run(model, params, prompts, args.new_tokens, profile=True)
    tokens = {"prefill": args.batch * args.prompt_len,
              "decode": args.batch * (args.new_tokens - 1)}
    report = {"arch": args.arch, "engine": args.engine, "batch": args.batch,
              "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
              "device": torch.cuda.get_device_name(0),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "phases": {}}
    for phase in ("prefill", "decode"):
        secs = plain[phase][0]
        row = {"tokens": tokens[phase], "wall_s": secs,
               "tokens_per_s": tokens[phase] / secs,
               "traced": summarize(traced[phase][1], traced[phase][0])}
        report["phases"][phase] = row
        fams = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
            row["traced"]["device_ms_by_family"].items(),
            key=lambda kv: -kv[1]))
        print(f"[profile] {phase}: {tokens[phase]} tokens in {secs:.4f} s "
              f"({row['tokens_per_s']:.1f} tok/s); traced: device busy "
              f"{row['traced']['device_busy_ms']:.3f} ms of "
              f"{row['traced']['traced_wall_ms']:.3f} ms "
              f"({row['traced']['device_busy_share']:.3f}); {fams}",
              flush=True)
    print(f"[profile] peak device memory {report['peak_memory_gb']:.2f} GB")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_serve_{args.engine}.json"),
                  "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
