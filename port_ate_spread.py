"""Spread of the port's bench-arc ATE over RANSAC seeds, on one NVIDIA GPU.

    python3 port_ate_spread.py [--seeds 7 8 9 ...]

The counterpart of reference_ate_spread.py for the port: chip_smoke.py's
main path (geometry mode, bench capacities, the rendered 60-degree arc,
bootstrap, a warm-up chunk, four timed chunks of 32 frames) once per seed,
with no gate. Prints one JSON line per seed with the frames tracked and the
sim3 ATE of the timed frames, then the median and the worst.
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
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_ate_spread: no CUDA device is available", file=sys.stderr)
        return 1
    ts, gt, images = chip_smoke.render_sequence()
    print(chip_smoke.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ates = []
    for seed in args.seeds:
        r = chip_smoke.run_main_path(ts, gt, images, seed)
        ates.append(r["ate_m"])
        print(json.dumps(r), flush=True)
    print(json.dumps({"median_ate_m": float(np.median(ates)), "max_ate_m": float(np.max(ates)),
                      "seeds": args.seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
