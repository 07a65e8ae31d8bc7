"""Spread of the port's bench-arc ATE over RANSAC seeds, on one NVIDIA GPU.

    python3 port_ate_spread.py [--flag EAO|LineAndiForest] [--seeds 7 8 9 ...] [--device cpu]
    python3 port_ate_spread.py --flag LineAndiForest --seeds 5 --record-yaw DIR
    python3 port_ate_spread.py --interactive [--flag EAO] [--seeds ...] [--device cpu]

The counterpart of reference_ate_spread.py for the port: chip_smoke.py's
main path (geometry mode, or with ``--flag EAO`` its EAO phase and with
``--flag LineAndiForest`` its line phase, with bench.py's boxes; bench
capacities, the rendered 60-degree arc, bootstrap, a warm-up chunk, four
timed chunks of 32 frames) once per seed, with no gate. Prints one JSON
line per seed with the frames tracked and the sim3 ATE of the timed
frames (with the object layer also the live objects, each scene object's
centre error, and each live object's elected yaw and yaw votes), then the
median and the worst. ``--device cpu``
runs the port on the host instead (about ten minutes a seed in EAO mode):
the same code on other arithmetic, to tell the card's share of a spread
from the port's. ``--record-yaw DIR`` (line mode) keeps every call of the
object pass's two yaw functions, ``yaw_sample_scores`` and ``update_yaw``,
with its inputs and outputs, and writes them to
``DIR/yaw_calls_seed<seed>.npz``; ``reference_ate_spread.py --replay-yaw``
runs the reference's functions on the same inputs. The recording copies
every call to the host, so a recorded run's fps is not the program's.
``--interactive`` runs the interactive per-frame tracker instead
(System(chunked=False), every frame of the arc through track_monocular,
chip_smoke.py's ``drive_interactive``, the protocol of
``reference_ate_spread.py --interactive``): per seed the frame that
initialized, the frames tracked after it, the sim3 ATE of every tracked
frame (and the objects with ``--flag EAO``), then the median and the
worst.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

import chip_smoke

TABLE_FIELDS = ("valid", "cls", "center", "cub_min", "cub_max", "yaw", "yaw_hist")
CALL_ARGS = ("targets", "boxes", "T_cw", "lines", "line_valid")


class YawCalls:
    """While entered, scan_tracker's names for the two yaw functions point
    to wrappers that keep a host copy of each call's table fields
    (``in_<field>``), arguments, scores (``counts``, ``errs``,
    ``n_lines``) and updated ``yaw_hist`` / ``yaw`` (``out_<field>``)."""

    def __enter__(self):
        from eao_slam_torch.runtime import scan_tracker

        self.module = scan_tracker
        self.saved = score, update = scan_tracker.yaw_sample_scores, scan_tracker.update_yaw
        self.calls = []

        def host(x):
            return x.detach().cpu().numpy()

        def recorded_score(cam, table, *args):
            out = score(cam, table, *args)
            call = {f"in_{f}": host(getattr(table, f)) for f in TABLE_FIELDS}
            call.update({k: host(a) for k, a in zip(CALL_ARGS, args)})
            call.update({k: host(x) for k, x in zip(("counts", "errs", "n_lines"), out)})
            self.calls.append(call)
            return out

        def recorded_update(table, *args):
            out = update(table, *args)
            self.calls[-1].update(out_yaw_hist=host(out.yaw_hist), out_yaw=host(out.yaw))
            return out

        scan_tracker.yaw_sample_scores, scan_tracker.update_yaw = recorded_score, recorded_update
        return self

    def __exit__(self, *exc):
        self.module.yaw_sample_scores, self.module.update_yaw = self.saved

    def save(self, path: str) -> None:
        np.savez_compressed(path, **{k: np.stack([c[k] for c in self.calls])
                                     for k in self.calls[0]})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=list(chip_smoke.SEEDS))
    p.add_argument("--flag", choices=("None", "EAO", "LineAndiForest"), default="None")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--interactive", action="store_true",
                   help="the interactive per-frame tracker, System(chunked=False)")
    p.add_argument("--record-yaw", metavar="DIR",
                   help="line mode: write every yaw call of each run to DIR")
    args = p.parse_args()
    if args.record_yaw and args.flag != "LineAndiForest":
        p.error("--record-yaw needs --flag LineAndiForest")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("port_ate_spread: no CUDA device is available", file=sys.stderr)
        return 1
    ts, gt, images = chip_smoke.render_sequence()
    print(chip_smoke.card_line() if args.device == "cuda" else "device: cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    boxes = chip_smoke.bench_boxes(gt) if args.flag != "None" else None
    runs = []
    for seed in args.seeds:
        if args.interactive:
            from eao_slam_torch.system import System

            sysm = System(chip_smoke.main_config(seed, boxes is not None, args.flag),
                          chunked=False, device=args.device)
            r = {"seed": seed, "flag": args.flag, "interactive": True,
                 **chip_smoke.drive_interactive(sysm, ts, gt, images, boxes)}
            runs.append(r)
            print(json.dumps(r), flush=True)
            continue
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(YawCalls()) if args.record_yaw else None
            r = chip_smoke.run_main_path(ts, gt, images, seed, boxes=boxes, device=args.device,
                                         flag=None if args.flag == "None" else args.flag)
        if calls is not None:
            os.makedirs(args.record_yaw, exist_ok=True)
            r["yaw_calls"] = os.path.join(args.record_yaw, f"yaw_calls_seed{seed}.npz")
            calls.save(r["yaw_calls"])
        r.pop("timer")
        r.pop("poses")
        runs.append(r)
        print(json.dumps(r), flush=True)
    ates = [r["ate_m"] for r in runs]
    summary = {"flag": args.flag, "device": args.device, "median_ate_m": float(np.median(ates)),
               "max_ate_m": float(np.max(ates)), "seeds": args.seeds,
               "min_tracked_share": min(r["tracked"] / r["total"] for r in runs)}
    if boxes is not None:
        summary["min_objects"] = min(r["objects"] for r in runs)
        summary["max_object_centre_err_m"] = max(max(r["object_centre_err_m"]) for r in runs)
        summary["max_supported_yaw_err_deg"] = max(
            [abs(o["yaw_deg"]) for r in runs for o in r.get("object_yaws", [])
             if o["votes"] >= 3], default=None)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
