"""Run cells of the benchmark several times, one process a run, as the
check runs them, and summarise: each run's exit code, wall time, `correct`,
metrics and compared numbers, then per cell and metric the median and the
spread (interquartile range over the median, by
``statistics.quantiles(values, n=4)``).

    python3 benchmark/sweep.py --cells tum3_eao.chunked --seeds 11 12 13 \
        --seconds 30 [--trace 0 1] [--control] [--out DIR]

``--control [FAULT]`` runs ``benchmark/control.py --fault FAULT`` instead
of ``run.py`` (default ``tf32``: the control). Each run's standard
output and error go to ``DIR/<cell>.<seed>.<trace>.{out,err}``; the card's
name and power limit head the summary.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values: list) -> float:
    if len(values) < 2:
        return float("nan")
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", nargs="+", type=int, default=[0])
    p.add_argument("--control", nargs="?", const="tf32", default=None,
                   help="run control.py with this --fault (default tf32)")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sweep"))
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    script = os.path.join(HERE, "control.py" if args.control else "run.py")
    results = {}
    for cell in args.cells:
        for trace in args.trace:
            for seed in args.seeds:
                tag = f"{cell}.{seed}.{trace}" + (f".{args.control}" if args.control else "")
                t0 = time.perf_counter()
                cmd = [sys.executable, script, "--workload", cell, "--seed", str(seed),
                       "--seconds", str(args.seconds), "--trace", str(trace)]
                if args.control:
                    cmd += ["--fault", args.control]
                proc = subprocess.run(cmd,
                                      capture_output=True, text=True, cwd=ROOT)
                wall = time.perf_counter() - t0
                with open(os.path.join(args.out, tag + ".out"), "w") as f:
                    f.write(proc.stdout)
                with open(os.path.join(args.out, tag + ".err"), "w") as f:
                    f.write(proc.stderr)
                line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
                try:
                    res = json.loads(line)
                except ValueError:
                    res = None
                if res is None:
                    print(f"{tag}: rc {proc.returncode} in {wall:.1f} s, no result: "
                          f"{proc.stderr.strip()[-1500:]}", flush=True)
                    continue
                vals = {k: v["value"] for k, v in res["metrics"].items()}
                chk = {k: v["value"] for k, v in res.get("checks", {}).items()}
                print(f"{tag}: rc {proc.returncode} in {wall:.1f} s, correct {res['correct']}, "
                      f"{res['attempted']} frames, {res['failed']} failed, metrics {vals}, "
                      f"checks {chk}, memory {res['device'].get('memory_peak_bytes')}, "
                      f"busy {res['device'].get('busy_s')}, window {res['device'].get('window_s')}, "
                      f"work {res.get('work')}", flush=True)
                if "breakdown" in res:
                    print(f"{tag}: breakdown {json.dumps(res['breakdown'])}", flush=True)
                for k, v in vals.items():
                    results.setdefault((cell, trace, k), []).append(v)
    for (cell, trace, k), v in sorted(results.items()):
        print(f"summary {cell} trace {trace} {k}: median {statistics.median(v)!r}, "
              f"spread {spread(v)!r}, n {len(v)}, values {v}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
