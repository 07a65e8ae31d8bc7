"""A cell's control, or a planted fault, at the cell's own size: ``run.py``'s
run with

    --fault tf32     (the default) the program's float32 matrix products in
                     TF32, the precision below the float32 the port states
                     and pins (its ``fp32_solvers`` turn TF32 on instead),
                     and for the front end's numbers the plain reference
                     computed in TF32 put in the program's place
    --fault NAME     a fault of ``harness/faults.py`` planted under the run

Its numbers are the upper readings the limits of ``benchmark/limits/`` are
set below; it should come out as not correct. The benchmark's own runs never
run it.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s> --trace 0 \
        [--fault tf32|stateless|coast|half_chunk|altered|objects_shifted]
"""

import argparse
import sys

from run import main

if __name__ == "__main__":
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--fault", default="tf32")
    args, rest = p.parse_known_args()
    sys.exit(main(rest, control=args.fault))
