"""Training launcher: any registered arch on the reference's synthetic
data, with the model in kernel mode.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \\
      --steps 8 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-110m \\
      --steps 6 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
      --steps 6 --batch 4 --seq 448
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \\
      --steps 200 --ckpt-dir ckpt/llama-1b --ckpt-every 50 --grad-compress
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
      --layers 1 --steps 4 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --layers 6 --steps 8 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 8 --batch 8 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b \\
      --steps 8 --batch 4 --seq 2048
  PYTHONPATH=src torchrun --nproc_per_node 1 -m repro_torch.launch.train \\
      --arch llama-1b --steps 4 --batch 4 --seq 1024 --mesh --zero1
  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --tiny --device cpu --steps 4 --seq 64 --mesh --zero1 --model-axis 2
  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --arch mamba2-130m --steps 6 --batch 8 --seq 1024 --mesh --zero1 \\
      --model-axis 4

The decoders and bert-110m take the LM pipeline's batches
(``data.DataIterator``), as the reference's launcher feeds every arch;
whisper-base and internvl2-2b take ``models.make_batch`` batches (random
target tokens over random ``encoder_embeds`` (B, 1500, 512), or behind
random ``patch_embeds`` (B, 256, 2048), ``--seq`` counting the patches),
since that pipeline has no frontend embeddings. ``--smoke`` takes an
arch's smoke config (e.g. mixtral-8x7b's: 2 layers, d_model 64, 4
experts), ``--layers`` cuts the
depth (mixtral-8x7b's published width trains at 1 layer on one 80 GB card,
recurrentgemma-2b's at 6, two periods of its ('rg', 'rg', 'local') pattern).
Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
versions on the CPU (with ``--tiny``: 2 layers, d_model 128, 4/2 heads,
d_ff 256, vocab 256, the width of the CPU tests; whisper's encoder 2 layers
over 64 frames; recurrentgemma's RG-LRU 128 wide; internvl2's 8
patches). Prints the reference launcher's ``[train] finished:`` line,
then tokens/s (median host time of the steps after the first; tokens of
the decoder's or encoder's sequence) and the peak device memory.

``--mesh`` trains over every process of a ``torchrun`` world
(``make_host_mesh``: NCCL and one card per process, or gloo with
``--device cpu``): data parallel over (world / ``--model-axis``) 'data'
ranks, each on its rows of the global ``--batch``, and tensor parallel
over ``--model-axis`` 'model' ranks (every arch: the attention heads,
FFN, experts, RG-LRU channels, Mamba2 heads and vocab by the reference's
rules), ``--zero1`` with the optimizer moments sliced over the 'data'
ranks; the first rank prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataIterator
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import MadeBatches, build_model
from repro_torch.optim import AdamWConfig, cosine_schedule, wsd_schedule
from repro_torch.train import FailureInjector, StragglerWatchdog, train_loop

TINY = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
            vocab_size=256, encoder_layers=2, encoder_seq=64)


def train_batches(cfg, batch: int, seq: int, *, seed: int = 0, device,
                  mesh=None):
    """The launcher's data: ``MadeBatches`` for the enc-dec and vlm
    families (their batches carry the stub frontend's embeddings), else the
    LM pipeline's iterator; over ``mesh`` this rank's rows of either."""
    if cfg.family in ("encdec", "vlm"):
        return MadeBatches(cfg, batch, seq, seed=seed, device=device,
                           mesh=mesh)
    return DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch, seed=seed),
                        device=device, mesh=mesh)


def _start_world(device: str, model_axis: int = 1):
    """The world of a ``torchrun`` launch: the process group from its
    environment (NCCL on the card, one per process, else gloo), this
    process's device and the (world / model_axis, model_axis) host
    mesh."""
    import os

    import torch.distributed as dist

    from .mesh import make_host_mesh

    cuda = not str(device).startswith("cpu")
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group("nccl" if cuda else "gloo")
    return device, make_host_mesh(model_axis,
                                  device_type="cuda" if cuda else "cpu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-1b",
                    help="a registered arch id; whisper-base trains on "
                    "make_batch batches (random encoder_embeds), the others "
                    "on the LM pipeline's")
    ap.add_argument("--tiny", action="store_true",
                    help="the CPU tests' width (2 layers, d_model 128; "
                    "whisper-base: 2 + 2 layers over 64 frames)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 error-feedback compression of the grads")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and save checkpoints to this directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mode", choices=["kernel", "reference"],
                    default="kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated node failures at these steps")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--mesh", action="store_true",
                    help="data parallel over the torchrun world")
    ap.add_argument("--zero1", action="store_true",
                    help="with --mesh: the moments sliced over the ranks")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="with --mesh: the 'model' extent (tensor "
                    "parallel); the rest of the world is 'data'")
    args = ap.parse_args(argv)
    mesh, device = None, args.device
    if args.mesh:
        device, mesh = _start_world(args.device, args.model_axis)
    try:
        return _run(ap, args, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(ap, args, device, mesh):
    import torch.distributed as dist

    show = mesh is None or dist.get_rank() == 0

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.tiny:
        cfg = dataclasses.replace(cfg, **TINY)
        if cfg.rglru is not None:   # the recurrence at the tiny width too
            cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
                cfg.rglru, lru_width=cfg.d_model))
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, num_patches=8)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if cfg.family == "encoder" and args.seq > cfg.max_seq_len:
        ap.error(f"--seq {args.seq}: {cfg.name} has {cfg.max_seq_len} "
                 "learned positions")
    sched = (wsd_schedule if args.schedule == "wsd" else cosine_schedule)(
        args.lr, args.warmup, args.steps)
    model = build_model(cfg, mode=args.mode, device=device, mesh=mesh)
    cuda = model.device.type == "cuda"
    data = train_batches(cfg, args.batch, args.seq, seed=args.seed,
                         device=model.device, mesh=mesh)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res = train_loop(model, data, args.steps, AdamWConfig(schedule=sched),
                     seed=args.seed, microbatches=args.microbatches,
                     mesh=mesh, zero1=args.zero1,
                     grad_compress=args.grad_compress,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     failure_injector=FailureInjector(tuple(args.fail_at)),
                     watchdog=StragglerWatchdog(),
                     log=print if show else (lambda *a, **k: None))
    if not show:
        return res
    print(f"[train] finished: {len(res.losses)} steps, "
          f"first loss {res.losses[0]:.4f}, last loss {res.losses[-1]:.4f}, "
          f"restarts {res.restarts}, stragglers {len(res.straggler_events)}")
    steady = res.step_seconds[1:] or res.step_seconds
    step_s = statistics.median(steady)
    where = torch.cuda.get_device_name(0) if cuda else "cpu"
    ranks = f" over {dist.get_world_size()} ranks" if mesh is not None else ""
    print(f"[train] {cfg.name}, {cfg.num_layers} layers, {args.batch} x "
          f"{args.seq} tokens a step on {where}{ranks}: median step "
          f"{step_s:.4f} s "
          f"after the first, {args.batch * args.seq / step_s:.1f} tokens/s")
    if cuda:
        print(f"[train] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    else:
        print("[train] peak device memory: not measured (cpu)")
    return res


if __name__ == "__main__":
    main()
