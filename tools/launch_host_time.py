#!/usr/bin/env python
"""Host time of the port's eager launches on one CUDA card.

  PYTHONPATH=src python tools/launch_host_time.py [--arch llama-1b]
      [--layers N] [--batch 4] [--prompt-len 256] [--reps 20] [--out FILE]

Everything is timed on the host clock, each run ended by a device
synchronise, after warm-up runs:

* ``gemm_fused`` at a shape the host bounds (M 128, N 512, K 512; the
  rmsnorm prologue with no epilogue, and the silu-gated chain), 500 calls
  in a loop, microseconds a call;
* the model's prefill (``--batch`` x ``--prompt-len`` seeded tokens, at
  published width, ``--layers`` where given) through an ``Engine``'s
  bucket, as ``Engine.generate`` runs it: the median and quartiles of
  ``--reps`` runs, in milliseconds;
* one more prefill under ``cProfile``: the 15 functions of most own time.

Prints one JSON line, with the card's name and power limit. It uses only
the serving API and ``gemm_fused``, which every tree of the port has, so
the same file times any tree: put that tree's ``src`` on ``PYTHONPATH`` to
compare two commits on one card (run parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pstats
import statistics
import subprocess
import time

import numpy as np
import torch


def gpu_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def gemm_us(calls: int = 500) -> dict:
    """Microseconds a ``gemm_fused`` call, by chain, over ``calls`` calls."""
    from repro_torch.kernels.gemm import Epilogue, gemm_fused
    from repro_torch.kernels.gemm.prologue import norm_prologue

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((128, 512), generator=gen, device="cuda").bfloat16()
    b = torch.randn((512, 512), generator=gen, device="cuda").bfloat16()
    gamma = torch.ones(512, device="cuda", dtype=torch.bfloat16)
    chains = {
        "rmsnorm": lambda: gemm_fused(a, b, prologue=norm_prologue("rmsnorm"),
                                      gamma=gamma),
        "silu*gate": lambda: gemm_fused(
            a, b, epilogue=Epilogue(activation="silu", gate=True), b2=b),
    }
    out = {}
    with torch.inference_mode():
        for name, fn in chains.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def prefill_ms(args) -> tuple:
    """(the prefill's ms: median, quartiles, runs; the cProfile top 15)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine

    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg, mode="kernel", device="cuda")
    params = model.init(seed=0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)), device="cuda")
    engine = Engine(model, params, max_len=args.prompt_len + 8)
    fn = engine._bucket(args.batch, args.prompt_len)
    cache = model.init_cache(args.batch, args.prompt_len + 8)
    runs = []
    with torch.inference_mode():
        for i in range(args.reps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params, prompts, cache)
            torch.cuda.synchronize()
            if i >= 2:
                runs.append((time.perf_counter() - t0) * 1e3)
        prof = cProfile.Profile()
        prof.enable()
        fn(params, prompts, cache)
        torch.cuda.synchronize()
        prof.disable()
    q = statistics.quantiles(runs, n=4)
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]
    return ({"median": statistics.median(runs), "q1": q[0], "q3": q[2],
             "runs": runs},
            [{"fn": f"{f[0].rsplit('/src/', 1)[-1]}:{f[1]}({f[2]})",
              "calls": v[1], "own_ms": v[2] * 1e3, "cum_ms": v[3] * 1e3}
             for f, v in top])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-1b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("launch_host_time: needs a CUDA card")
    from repro_torch import kernels

    kernels.build_all()
    prefill, top = prefill_ms(args)
    report = {"gpu": gpu_line(), "arch": args.arch,
              "batch": args.batch, "prompt_len": args.prompt_len,
              "gemm_fused_us": gemm_us(), "prefill_ms": prefill,
              "prefill_cprofile_top": top}
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
