"""Step time of the training step over a one-rank ('data', 'model') mesh
against the single-device step, on one CUDA card.

  PYTHONPATH=src python tools/mesh_step_time.py --arch bert-110m \\
      whisper-base mamba2-130m:4 [--steps 8] [--out FILE]

Each arch (``name``, or ``name:layers`` to cut the depth) is built at
published width in kernel mode with seeded random weights and trained on
``make_batch`` batches of 2 x 1024 tokens (an encoder's 4 x 512), as
``chip_smoke.py`` phase 23a does. In turns: the single-device step, the
(1, 1) mesh step (``make_train_step(mesh=, zero1=True)`` in one NCCL
process group of world size 1), the mesh step again, the single step
again, each from the same weights. Prints one JSON line per arch with the
median step seconds after the first of each run, and the card's name and
power limit. It uses only the port's training API, so the same file times
any tree that has the mesh step: put that tree's ``src`` on
``PYTHONPATH`` to compare two commits on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import subprocess
import tempfile
import time

import torch


def gpu_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def median_step(cfg, params, batches, mesh) -> float:
    """The median seconds of the steps after the first, each ended by
    reading its loss."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.state import sharded_init

    model = build_model(cfg, mode="kernel", device="cuda", mesh=mesh)
    opt = AdamWConfig(schedule=cosine_schedule(1e-4, 2, len(batches)))
    if mesh is None:
        state = init_state(model, params=params)
        step = make_train_step(model, opt)
    else:
        state = sharded_init(model, 0, mesh, zero1=True, params=params)
        step = make_train_step(model, opt, mesh=mesh, zero1=True)
    secs = []
    torch.cuda.synchronize()
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        secs.append(time.perf_counter() - t0)
    del state, step, model
    torch.cuda.empty_cache()
    return statistics.median(secs[1:])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", required=True,
                    help="name or name:layers")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_step_time: needs a CUDA card")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.api import make_batch

    kernels.build_all()
    card = gpu_line()
    tmp = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    rows = []
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for spec in args.arch:
            name, _, layers = spec.partition(":")
            cfg = get_config(name)
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=int(layers))
            seq = 512 if cfg.family == "encoder" else 1024
            gen = torch.Generator(device="cuda").manual_seed(23)
            batches = [make_batch(cfg, 2048 // seq, seq, generator=gen)
                       for _ in range(args.steps)]
            params = build_model(cfg, mode="reference", device="cuda").init(
                seed=0, dtype=cfg.param_dtype)
            times = {"single": [], "mesh": []}
            for run in ("single", "mesh", "mesh", "single"):
                times[run].append(median_step(
                    cfg, params, batches, mesh if run == "mesh" else None))
            row = {"arch": name, "layers": cfg.num_layers,
                   "tokens": 2048, "steps": args.steps,
                   "single_s": times["single"], "mesh_s": times["mesh"],
                   "mesh_over_single": (sum(times["mesh"])
                                        / sum(times["single"])),
                   "card": card}
            print(json.dumps(row), flush=True)
            rows.append(row)
            del params, batches
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
