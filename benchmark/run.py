"""Run one cell of the benchmark of eao_slam_torch once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
and a traffic mix under ``benchmark/``. The run loads (or, the first time
in a checkout, renders) the cell's frames, builds the FAST kernel into the
port's ``build/eao_slam_torch/``, constructs ``System``, bootstraps and warms
up (set-up), then feeds the window: the next ``--seconds`` x the traffic's
``window_fps`` frames, a fixed amount of work that lasts about ``--seconds``.
With ``--trace 1`` it also times the spans that the cell's per-layer
metrics read over the window, profiles a stretch after it, and reports the
per-layer metrics instead of the end-to-end ones. It then checks the window's output against the plain
reference and the generator's truth, prints each compared number beside
its limit as the last lines of standard error, and one JSON line last on
standard output. ``--seed`` sets the system's RANSAC seed and nothing else.
Needs an NVIDIA card; with none it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

THREADS = 2          # host threads of every library, fixed: the machine's cores are shared
HERE = os.path.dirname(os.path.abspath(__file__))
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(THREADS)
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "cache", "triton")
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main(argv=None, control: str = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from harness import check
    from harness.runner import run_cell
    from harness.spec import Spec

    torch.set_num_threads(THREADS)
    spec = Spec()
    chips = int(spec.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, lines = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                             T_START, control=control)
    bad = check.forbidden_modules()
    if bad:
        print(f"run.py: the run loaded JAX or the JAX package: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
