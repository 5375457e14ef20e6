"""Where the served main path spends its time on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch llama-1b \\
      --batch 4 --prompt-len 256 --new-tokens 32 [--engine paged] --out DIR
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch whisper-base --prompt-len 64 --out DIR
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --engine paged \\
      --batch 8 --spec-tokens 4 [--draft self|layers:N] --out DIR
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch mixtral-8x7b --layers 4 --out DIR
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch recurrentgemma-2b --prompt-len 2304 [--engine paged] --out DIR
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch mamba2-130m --prompt-len 4096 --new-tokens 64 --out DIR
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch internvl2-2b --prompt-len 1024 [--engine paged] --out DIR
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      --arch llama4-maverick-400b-a17b --layers 2 [--engine paged] --out DIR

Builds the model in kernel mode with seeded random weights (at its
published width, cut to ``--layers`` layers where given: mixtral-8x7b's 32
are ~93 GB in bf16, more than one card holds, llama4-maverick's 48 ~790
GB, 36.9 at 2 layers; recurrentgemma-2b runs its 26 whole, 5.8 GB;
internvl2-2b serves its LM backbone on text, as the reference's), warms it
up,
then runs one prefill and the decode steps of one batch twice: once untimed
by the profiler (host clock around work ended by a device synchronise), and
once under ``torch.profiler``. ``--engine fixed`` (the default) drives an
``Engine``'s buckets as ``Engine.generate`` does: the prefill, then the
decode steps replayed from the ``("decode", batch)`` bucket's CUDA graph;
``--engine paged`` drives a ``PagedEngine`` (``--batch`` slots, 64-token
pages): prefill is the admission of every request (one exact-length
prefill each), decode is the engine's steps, replayed from its page
buckets' graphs, until all have retired; with ``--spec-tokens K`` the
engine decodes by greedy speculative rounds (``--draft self``: the target
drafts for itself; ``layers:N``: a layer-skip draft of the target's
embedding, final norm and first N blocks), each round k draft steps and
one verify replayed from the ``draft_decode`` and ``verify`` buckets'
graphs, and the decode phase also reports its rounds and, per round, the
device busy time and the host's launch calls. An encoder-decoder (whisper-base)
takes the fixed engine only; its prefill is the encoder over seeded
``encoder_embeds`` (batch, encoder_seq, d_model) and the decoder's prefill,
as ``Engine.generate(..., extra_batch=...)`` runs them. One engine serves the warm-up
and both runs, so the graphs are captured in the warm-up. From the trace
it reports, for prefill and decode apart, the device time by kernel family
(the port's kernels, the library matrix products that the reference also
leaves to the compiler, and the other torch operations), the device's busy
share of the traced window, the host's launch calls (kernel launches and
graph launches, by API name) and the peak device memory. Needs a CUDA
card; writes ``DIR/profile_serve_<engine>.json`` and prints one summary
line per phase.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.common import tree_map
from repro_torch.serve import Engine, PagedEngine, Request

# kernel name fragment -> family, checked in order
FAMILIES = (
    # the forward GEMM: the norm row pass, the mainloop (fused epilogue,
    # or split partials) and the split-K reduce
    ("gemm_fused_rows_kernel", "gemm_fused"),
    ("gemm_fused_kernel", "gemm_fused"),
    ("gemm_fused_splitk_kernel", "gemm_fused"),
    ("gemm_fused_reduce_kernel", "gemm_fused"),
    # the GEMM backward: operand pass, dA (GEMM and norm row pass), dB;
    # listed above the catch-all "gemm" below
    ("gemm_bwd_g_", "gemm_bwd_g"),
    ("gemm_bwd_da_kernel", "gemm_bwd_da"),
    ("norm_transpose_kernel", "gemm_bwd_da"),
    ("gemm_bwd_db_kernel", "gemm_bwd_db"),
    # the flash backward: the main kernel and the dq convert pass
    ("flash_bwd_kernel", "flash_attention_bwd"),
    ("flash_bwd_dq_convert_kernel", "flash_attention_bwd"),
    ("flash_fwd_kernel", "flash_attention_fwd"),
    # the split-KV decode kernels (decode_split.cuh's body<D, WK, PAGED,
    # CAP>), their splits' merge inside the same launch: no merge kernel
    ("flash_decode_paged_kernel", "flash_decode_paged"),
    ("flash_decode_kernel", "flash_decode"),
    ("rope_kernel", "rope"),
    ("fused_norm_kernel", "fused_norm"),
    ("nccl", "nccl"),               # the collectives' kernels
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


# host API calls that put work on the device's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def summarize(prof, wall_s: float) -> dict:
    """The traced device time by kernel family, launches, busy share; and
    the 12 other-torch kernels of most device time ([name (its first 160
    characters), ms, launches])."""
    by_family: dict = {}
    launches: dict = {}
    host_calls: dict = {}
    others: dict = {}
    intervals = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            if ev.name in LAUNCH_CALLS:
                host_calls[ev.name] = host_calls.get(ev.name, 0) + 1
            continue
        fam = family(ev.name)
        dur = ev.time_range.elapsed_us()
        by_family[fam] = by_family.get(fam, 0.0) + dur / 1e3
        launches[fam] = launches.get(fam, 0) + 1
        if fam == "other_torch":
            ms, n = others.get(ev.name[:160], (0.0, 0))
            others[ev.name[:160]] = (ms + dur / 1e3, n + 1)
        intervals.append((ev.time_range.start, ev.time_range.end))
    busy_ms = _union_us(intervals) / 1e3
    span_ms = ((max(e for _, e in intervals) - min(s for s, _ in intervals))
               / 1e3 if intervals else 0.0)
    return {"device_ms_by_family": by_family,
            "device_launches_by_family": launches,
            "host_launch_calls": host_calls,
            "device_busy_ms": busy_ms, "traced_wall_ms": wall_s * 1e3,
            "device_busy_share": busy_ms / (wall_s * 1e3),
            "device_first_to_last_ms": span_ms,
            "other_torch_top": [[k, ms, n] for k, (ms, n) in sorted(
                others.items(), key=lambda kv: -kv[1][0])[:12]]}


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


def run_phases(engine, prompts, new_tokens: int, profile: bool,
               extra_batch=None):
    """One prefill and ``new_tokens - 1`` greedy decode steps through the
    engine's buckets, as ``Engine.generate`` runs them (an encoder-decoder's
    prefill takes ``dict(extra_batch, inputs=prompts)``); returns {phase:
    (seconds, profiler or None)}."""
    b, s = prompts.shape
    prefill_fn = engine._bucket(b, s)
    step = engine._decode_fn(b)
    batch = prompts if extra_batch is None else dict(extra_batch,
                                                     inputs=prompts)
    state = {}

    def prefill():
        _, logits = prefill_fn(engine.params, batch, step.cache)
        state["tok"] = torch.argmax(logits, dim=-1)[:, None]

    def decode():
        for i in range(new_tokens - 1):
            logits = step(token=state["tok"], pos=s + i)
            state["tok"] = torch.argmax(logits, dim=-1)[:, None]

    with torch.inference_mode():
        return {name: _timed(fn, profile)
                for name, fn in (("prefill", prefill), ("decode", decode))}


PAGE = 64


def run_phases_paged(engine, prompts, new_tokens: int, profile: bool):
    """The same work through a PagedEngine with one slot per prompt: the
    admissions (exact-length prefills), then the engine's steps."""
    first = engine.admissions
    for uid, row in enumerate(prompts.cpu().numpy()):
        engine.submit(Request(first + uid, row.astype(np.int32), new_tokens))

    def decode():
        while engine.step():
            pass

    with torch.inference_mode():
        # _admit is the engine's admission step: every prompt finds a slot
        return {"prefill": _timed(engine._admit, profile),
                "decode": _timed(decode, profile)}


def draft_model(spec: str, cfg, model, params) -> tuple:
    """(draft model, its params) of ``--draft``: ``self`` or ``layers:N``
    (the target's embedding, final norm and first N blocks, views of its
    stacked leaves)."""
    if spec == "self":
        return model, params
    kind, _, n = spec.partition(":")
    if kind != "layers" or not n.isdigit() or not 0 < int(n) <= cfg.num_layers:
        raise ValueError(f"--draft {spec!r}: self or layers:N, 0 < N <= "
                         f"{cfg.num_layers}")
    n = int(n)
    return (build_model(dataclasses.replace(cfg, num_layers=n),
                        mode=model.mode, device=model.device),
            {**params, "blocks": tree_map(lambda x: x[:n], params["blocks"])})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-1b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the published depth to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=("fixed", "paged"), default="fixed")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="paged engine: decode by speculative rounds of k")
    ap.add_argument("--draft", default="self",
                    help="with --spec-tokens: self or layers:N")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.spec_tokens and args.engine != "paged":
        raise ValueError("--spec-tokens needs --engine paged")

    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if cfg.family == "encoder" or (cfg.family == "encdec"
                                   and args.engine == "paged"):
        raise NotImplementedError(
            f"{args.arch}: the {cfg.family!r} family is not served by the "
            f"{args.engine} engine")
    model = build_model(cfg, mode="kernel", device="cuda")
    params = model.init(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        device="cuda")
    extra = {}
    if cfg.family == "encdec":
        extra["extra_batch"] = {"encoder_embeds": torch.as_tensor(
            rng.standard_normal((args.batch, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.bfloat16, device="cuda")}
    max_len = args.prompt_len + args.new_tokens
    if args.engine == "paged":
        spec = {}
        if args.spec_tokens:
            d_model, d_params = draft_model(args.draft, cfg, model, params)
            spec = dict(draft_model=d_model, draft_params=d_params,
                        spec_tokens=args.spec_tokens)
        pages = -(-(max_len + args.spec_tokens) // PAGE)
        engine = PagedEngine(model, params, batch_slots=args.batch,
                             page_size=PAGE,
                             max_pages_per_seq=1 << (pages - 1).bit_length(),
                             **spec)
        run = run_phases_paged
    else:
        engine = Engine(model, params, max_len=max_len)
        run = run_phases
    # warm-up: the decode graphs of the buckets the runs use are captured
    run(engine, prompts, args.new_tokens, profile=False, **extra)
    torch.cuda.reset_peak_memory_stats()
    plain = run(engine, prompts, args.new_tokens, profile=False, **extra)
    rounds = getattr(engine, "spec_rounds", 0)
    traced = run(engine, prompts, args.new_tokens, profile=True, **extra)
    rounds = getattr(engine, "spec_rounds", 0) - rounds
    tokens = {"prefill": args.batch * args.prompt_len,
              "decode": args.batch * (args.new_tokens - 1)}
    report = {"arch": args.arch, "layers": cfg.num_layers,
              "engine": args.engine, "batch": args.batch,
              "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
              "spec_tokens": args.spec_tokens,
              "draft": args.draft if args.spec_tokens else None,
              "device": torch.cuda.get_device_name(0),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "phases": {}}
    for phase in ("prefill", "decode"):
        secs = plain[phase][0]
        row = {"tokens": tokens[phase], "wall_s": secs,
               "tokens_per_s": tokens[phase] / secs,
               "traced": summarize(traced[phase][1], traced[phase][0])}
        if phase == "decode" and rounds:
            tr = row["traced"]
            row["spec"] = engine.report()["speculative"]
            row["traced_rounds"] = rounds
            row["per_round"] = {
                "device_busy_ms": tr["device_busy_ms"] / rounds,
                "wall_ms": tr["traced_wall_ms"] / rounds,
                "host_launch_calls": {k: n / rounds for k, n in
                                      tr["host_launch_calls"].items()}}
            print(f"[profile] decode by {rounds} speculative rounds "
                  f"(k {args.spec_tokens}, {args.draft} draft; "
                  f"{row['spec']}): per round {row['per_round']}",
                  flush=True)
        report["phases"][phase] = row
        fams = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
            row["traced"]["device_ms_by_family"].items(),
            key=lambda kv: -kv[1]))
        print(f"[profile] {phase}: {tokens[phase]} tokens in {secs:.4f} s "
              f"({row['tokens_per_s']:.1f} tok/s); traced: device busy "
              f"{row['traced']['device_busy_ms']:.3f} ms of "
              f"{row['traced']['traced_wall_ms']:.3f} ms "
              f"({row['traced']['device_busy_share']:.3f}); host launch "
              f"calls {row['traced']['host_launch_calls']}; {fams}",
              flush=True)
    print(f"[profile] peak device memory {report['peak_memory_gb']:.2f} GB")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = args.engine + (f"_spec{args.spec_tokens}"
                              if args.spec_tokens else "")
        with open(os.path.join(args.out, f"profile_serve_{name}.json"),
                  "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
