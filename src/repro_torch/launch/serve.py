"""Serving launcher: batched greedy generation through the request queue,
with the model in kernel mode (``--mode reference``: the plain path).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-1b \\
      --requests 8 --prompt-len 256 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --no-smoke --layers 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --no-smoke --layers 4
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --no-smoke --prompt-len 2304 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --no-smoke --prompt-len 4096 --new-tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \\
      --no-smoke --prompt-len 1024 --new-tokens 32

``--arch`` takes every decoder-only id of ``repro_torch.configs`` and
internvl2-2b, whose LM backbone serves text only, as the reference's; the
smoke variant of a config is the default (``--no-smoke``: the published
one; the llama ids have one config; recurrentgemma-2b's 26 layers,
mamba2-130m's 24 and internvl2-2b's 24 fit one card whole), and
``--layers`` cuts its depth. As
in the reference, the request queue serves decoder-only LMs only:
whisper-base is served through ``Engine.generate(..., extra_batch=...)``
(``launch/profile_serve.py --arch whisper-base``) and bert-110m has no
decode step; both are refused here. Runs on the CUDA card by
default; ``--device cpu`` runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import DECODER_FAMILIES, get_config
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import MODES, build_model
from repro_torch.serve import Engine, Request, RequestQueue


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--mode", choices=MODES, default="kernel")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"{args.arch}: the serving launcher's request queue serves "
            f"decoder-only LMs, not the {cfg.family!r} family (as the "
            "reference's); serve an encoder-decoder through "
            "Engine.generate(..., extra_batch={'encoder_embeds': ...}); an "
            "encoder has no decode step")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg, mode=args.mode, device=args.device)
    params = model.init(seed=0)
    engine = Engine(model, params,
                    max_len=args.prompt_len + args.new_tokens + 8)
    queue = RequestQueue(engine, args.batch_size, buckets=(args.prompt_len,))

    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        plen = rng.integers(args.prompt_len // 2, args.prompt_len + 1)
        queue.submit(Request(uid, rng.integers(0, cfg.vocab_size, plen)
                             .astype(np.int32), args.new_tokens,
                             temperature=args.temperature))
    served = queue.flush(force=True)
    print(f"[serve] served {served} requests "
          f"({len(queue.results)} unique results)")
    for uid in sorted(queue.results)[:4]:
        print(f"  req {uid}: {queue.results[uid][-args.new_tokens:]}")


if __name__ == "__main__":
    main()
