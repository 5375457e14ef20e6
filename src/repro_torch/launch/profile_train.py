"""Where one training step spends its time on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_train --arch llama-1b \\
      --batch 4 --seq 1024 --out DIR
  (also --arch bert-110m --batch 8 --seq 512; --arch whisper-base --batch 4
  --seq 448; --arch mixtral-8x7b --layers 1; --arch recurrentgemma-2b
  --layers 6 --batch 2 --seq 4096; --arch mamba2-130m --batch 8 --seq
  4096; --arch internvl2-2b --batch 4 --seq 2048; the training levers:
  --ce-chunk 256, --remat-policy dots|none)
  PYTHONPATH=src torchrun --nproc_per_node 4 -m \\
      repro_torch.launch.profile_train --arch llama-1b --batch 4 --seq 1024 \\
      --mesh --zero1 --model-axis 1 --out DIR
  (any arch over the mesh, e.g. --arch recurrentgemma-2b --layers 6 --batch
  4 --seq 2048 --mesh --zero1 --model-axis 2)

Builds the model in kernel mode with seeded random fp32 masters, runs two
warm-up steps on the training launcher's data (the reference's synthetic
LM batches; whisper-base's and internvl2-2b's from ``make_batch``), one
step timed by the host clock (ended by a device synchronise) and one step
under ``torch.profiler``. From the trace it reports the device time by kernel
family (the port's kernels, forward and backward, the library matrix
products, the other torch operations), the device's busy share of the
traced step, and the peak device memory. Needs a CUDA card; writes
``DIR/profile_train.json`` and prints one summary line. With ``--mesh``,
under ``torchrun``, the step is ``make_train_step(mesh=)``'s over the
launch's (world / ``--model-axis``, ``--model-axis``) mesh, as
``launch/train.py --mesh`` trains (every arch, every family split over
'model' by the reference's rules), each rank on its rows of the global
``--batch``; every rank prints its line (the NCCL kernels are the family
"nccl"), the first writes its report.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import init_state, make_train_step, sharded_init
from .profile_serve import _timed, summarize
from .train import _start_world, train_batches


def profile_step(model, batch: int, seq: int, *, seed: int = 0,
                 warmup: int = 2, mesh=None, zero1: bool = False) -> dict:
    """Warm-up steps, then one untraced and one traced step of ``model``
    (over ``mesh``: the split step on this rank's blocks and rows):
    {"step_s", "tokens_per_s", "traced": summarize(...)}."""
    data = train_batches(model.cfg, batch, seq, seed=seed,
                         device=model.device, mesh=mesh)
    opt = AdamWConfig(schedule=cosine_schedule(3e-4, 2, warmup + 2))
    if mesh is None:
        state = init_state(model, seed)
    else:
        state = sharded_init(model, seed, mesh, zero1=zero1)
    step = make_train_step(model, opt, mesh=mesh, zero1=zero1)

    def one():
        step(state, next(data))

    for _ in range(warmup):
        one()
    plain_s, _ = _timed(one, profile=False)
    traced_s, prof = _timed(one, profile=True)
    return {"step_s": plain_s, "tokens_per_s": batch * seq / plain_s,
            "traced": summarize(prof, traced_s)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-1b",
                    help="a registered arch id (bert-110m: --seq 512 at "
                    "most; whisper-base: make_batch batches over 1500 "
                    "random frames, --seq target tokens)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (mixtral-8x7b "
                    "trains at 1 layer of published width on one card, "
                    "recurrentgemma-2b at 6)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ce-chunk", type=int, default=None,
                    help="the chunked cross entropy over this many "
                    "positions (default: the config's)")
    ap.add_argument("--remat-policy", choices=["full", "dots", "none"],
                    default=None, help="default: the config's")
    ap.add_argument("--mesh", action="store_true",
                    help="the split step over the torchrun world")
    ap.add_argument("--zero1", action="store_true",
                    help="with --mesh: the moments sliced over 'data'")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="with --mesh: the 'model' extent (any arch)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.mesh:
        return _run(args, "cuda", None, 0)
    import torch.distributed as dist

    device, mesh = _start_world("cuda", args.model_axis)
    try:
        return _run(args, device, mesh, dist.get_rank())
    finally:
        dist.destroy_process_group()


def _run(args, device, mesh, rank: int) -> dict:

    cfg = get_config(args.arch)
    levers = {"ce_chunk": args.ce_chunk, "remat_policy": args.remat_policy,
              "num_layers": args.layers}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in levers.items()
                                      if v is not None})
    model = build_model(cfg, mode="kernel", device=device, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    row = profile_step(model, args.batch, args.seq, seed=args.seed,
                       mesh=mesh, zero1=args.zero1)
    where = "" if mesh is None else (
        f" rank {rank} of mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    report = {"arch": args.arch, "layers": cfg.num_layers,
              "batch": args.batch, "seq": args.seq,
              "remat_policy": cfg.remat_policy, "ce_chunk": cfg.ce_chunk,
              "mesh": where.strip() or None,
              "device": torch.cuda.get_device_name(),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              **row}
    tr = row["traced"]
    fams = ", ".join(f"{k} {v:.3f} ms ({tr['device_launches_by_family'][k]})"
                     for k, v in sorted(tr["device_ms_by_family"].items(),
                                        key=lambda kv: -kv[1]))
    print(f"[profile]{where} train step: {args.batch} x {args.seq} tokens in "
          f"{row['step_s']:.4f} s ({row['tokens_per_s']:.1f} tok/s); traced: "
          f"device busy {tr['device_busy_ms']:.3f} ms of "
          f"{tr['traced_wall_ms']:.3f} ms ({tr['device_busy_share']:.3f}); "
          f"{fams}", flush=True)
    for name, ms, n in tr["other_torch_top"][:6]:
        print(f"[profile]{where} other torch: {ms:.3f} ms ({n}) {name}")
    print(f"[profile]{where} peak device memory "
          f"{report['peak_memory_gb']:.2f} GB", flush=True)
    if args.out and rank == 0:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_train.json"), "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
