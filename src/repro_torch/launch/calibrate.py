"""Calibrate the policy layer on the card and gate its drift.

  PYTHONPATH=src python -m repro_torch.launch.calibrate \\
      --out src/repro_torch/configs/pretuned/h100.json
  PYTHONPATH=src python -m repro_torch.launch.calibrate --smoke \\
      --out CALIB_h100.json
  PYTHONPATH=src python -m repro_torch.launch.calibrate --device cpu \\
      --smoke --out /tmp/CALIB_cpu.json

On the card every candidate of llama-1b's main-path cells
(``core.calibrate.default_sweep``: its forward and backward GEMMs, every
tile width x split x walk window, and its decode attention's splits) is
launched on seeded operands and timed by CUDA-graph replay with a cold L2
(``core.calibrate.CardMeasure``); the report, an installable pretuned
table of arch "h100" whose metadata carries the card's name and power
limit, goes to ``--out``. ``--device cpu`` prices the candidates with the
proxy rig instead (arch "cpu"). Then ``check_drift``'s Spearman correlation
and top-1 agreement per op family are printed, with each violation, and
per cell the measured best against the analytic pick (the hand-fitted
plan) in microseconds. The exit code is the drift gate's, as the
reference's ``tools/drift_check.py``: 1 when the analytic ranking has
drifted from the measured one (the report is written all the same), else 0.
"""
from __future__ import annotations

import argparse
import subprocess
import sys


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run(args) -> dict:
    import torch

    from repro_torch.core import calibrate as cal
    from repro_torch.core.autotune import default_arch

    measure, metadata, sms = None, {}, None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("calibrate: no CUDA device (pass --device cpu "
                             "for the proxy rig)")
        from repro_torch import kernels
        from repro_torch.kernels.gemm.ops import sm_count

        kernels.build_all()
        dev = torch.device("cuda")
        measure = cal.CardMeasure(dev, seed=args.seed)
        sms = sm_count(dev)
        metadata = {"card": card_line(), "sms": sms,
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "timer": "CUDA-graph replay, median of 10, L2 scrubbed"}
        arch = default_arch()
    else:
        arch = "cpu"
    report = cal.calibrate(cal.default_sweep(smoke=args.smoke),
                           measure_fn=measure, top_k=args.top_k,
                           seed=args.seed, arch=arch, sms=sms,
                           metadata=metadata)
    cal.save_report(report, args.out)
    return report


def summary(report: dict) -> list:
    """Lines: the drift gate per op family, then each cell's measured best
    against the analytic pick."""
    from repro_torch.core import calibrate as cal

    drift = cal.check_drift(report)
    lines = [f"[calibrate] arch {report['arch']}, {drift['n_cells']} cells, "
             f"drift ok={drift['ok']}"]
    for op, fam in drift["families"].items():
        lines.append(f"[calibrate] {op}: cells {fam['cells']}, top-1 "
                     f"agreement {fam['top1_agreement']:.3f}, mean Spearman "
                     f"{fam['mean_spearman']:.3f}")
    lines += [f"[calibrate] VIOLATION: {v}" for v in drift["violations"]]
    for key, cell in sorted(report["cells"].items()):
        best = min(cell["candidates"], key=lambda c: c["measured_time_s"])
        pick = cell["candidates"][0]
        lines.append(
            f"[calibrate] {key}: best {best['measured_time_s'] * 1e6:.2f} us "
            f"(width {best['blocks'][1]}, splits {best['splits']}, window "
            f"{best['window']}) vs pick {pick['measured_time_s'] * 1e6:.2f} "
            f"us (width {pick['blocks'][1]}, splits {pick['splits']}, "
            f"window {pick['window']}) of {len(cell['candidates'])}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="CALIB_h100.json")
    ap.add_argument("--smoke", action="store_true",
                    help="the prefill, decode and prefill-backward cells "
                         "only (no training shapes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=64,
                    help="candidates timed a cell, by the analytic ranking")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    report = run(args)
    for line in summary(report):
        print(line, flush=True)
    print(f"[calibrate] wrote {args.out}", flush=True)
    from repro_torch.core import calibrate as cal
    return 0 if cal.check_drift(report)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
