"""Spread of the port's bench-arc ATE over RANSAC seeds, on one NVIDIA GPU.

    python3 port_ate_spread.py [--flag EAO] [--seeds 7 8 9 ...] [--device cpu]

The counterpart of reference_ate_spread.py for the port: chip_smoke.py's
main path (geometry mode, or with ``--flag EAO`` its EAO phase with
bench.py's boxes; bench capacities, the rendered 60-degree arc, bootstrap,
a warm-up chunk, four timed chunks of 32 frames) once per seed, with no
gate. Prints one JSON line per seed with the frames tracked and the sim3
ATE of the timed frames (in EAO mode also the live objects and each scene
object's centre error), then the median and the worst. ``--device cpu``
runs the port on the host instead (about ten minutes a seed in EAO mode):
the same code on other arithmetic, to tell the card's share of a spread
from the port's.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import chip_smoke


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=list(chip_smoke.SEEDS))
    p.add_argument("--flag", choices=("None", "EAO"), default="None")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("port_ate_spread: no CUDA device is available", file=sys.stderr)
        return 1
    ts, gt, images = chip_smoke.render_sequence()
    print(chip_smoke.card_line() if args.device == "cuda" else "device: cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    boxes = chip_smoke.bench_boxes(gt) if args.flag == "EAO" else None
    runs = []
    for seed in args.seeds:
        r = chip_smoke.run_main_path(ts, gt, images, seed, boxes=boxes, device=args.device)
        r.pop("timer")
        r.pop("poses")
        runs.append(r)
        print(json.dumps(r), flush=True)
    ates = [r["ate_m"] for r in runs]
    summary = {"flag": args.flag, "device": args.device, "median_ate_m": float(np.median(ates)),
               "max_ate_m": float(np.max(ates)), "seeds": args.seeds}
    if boxes is not None:
        summary["min_objects"] = min(r["objects"] for r in runs)
        summary["max_object_centre_err_m"] = max(max(r["object_centre_err_m"]) for r in runs)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
